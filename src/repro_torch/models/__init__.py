"""Model code of the port: layers, attention and the dense transformer."""
