"""Distribution: the sharding rules (``sharding``), the ambient mesh and
batch axes the models read (``context``), and the models' regions over
DTensors (``parallel``)."""
