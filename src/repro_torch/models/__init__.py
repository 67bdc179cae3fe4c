"""Model code of the port: layers, attention, the Mamba2 mixer and the
decoder stack."""
