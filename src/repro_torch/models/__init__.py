"""The dense decoder of the port: layers, model, factory, weight carry-over."""
