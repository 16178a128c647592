"""nn.Modules of the network, with the reference's torch parameter names."""
