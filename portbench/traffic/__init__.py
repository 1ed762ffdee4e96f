"""One driver per traffic kind, and the HTTP load generator."""
