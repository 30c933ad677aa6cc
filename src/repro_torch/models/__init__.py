"""LM model stack of the port: the dense decoder family (``transformer``),
its attention and layers, the family registry and the weight converter."""
