"""The harness of the port's benchmark: running a cell, its trace slice,
the model's work, the generator and the output reader."""
