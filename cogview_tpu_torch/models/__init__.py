"""Models of the port: the CogView GPT, the VQ-VAE decoder, the params bridge."""
