"""Command-line tools for measuring the port on the card."""
