"""Plain torch operators: losses, samplers and the stroke featurizers."""
