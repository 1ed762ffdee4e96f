"""Model code of the PyTorch port: networks (towers and the precision
policy), vae (one modality), conv and sketch_rnn (the conv image tower and
Sketch-RNN's stroke tower) and assoc (the joint model)."""
