"""Model code of the PyTorch port: networks (towers and the precision
policy), vae (one modality) and assoc (the joint model)."""
