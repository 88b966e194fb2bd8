"""Models of the port: layers, GQA attention and the dense LM."""
