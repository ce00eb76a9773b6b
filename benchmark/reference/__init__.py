"""The benchmark's plain reference: RiboDetector's classifier, its encoder,
the paired-end ensure rules, the loss and Adam, in plain PyTorch and NumPy.

It imports nothing of the program under test (``ribodetector_tpu_torch``)
nor of the JAX package, and reads nothing the program made: the weights
come from the npz file both sides read, and the reads from the benchmark's
own generator.
"""
