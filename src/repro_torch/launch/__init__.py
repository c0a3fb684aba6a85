"""Entry points of the port: serving and training with their step
functions, and the dry run with its meshes, cost model and roofline."""
