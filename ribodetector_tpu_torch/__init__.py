"""PyTorch/CUDA port of the rRNA read-classification engine.

A second package beside ``ribodetector_tpu`` (the JAX reference, which it
never imports). It streams FASTQ/FASTA reads through the same host-side
parser and encoder into the same single-layer bidirectional LSTM
classifier, here run by kernels written by hand for NVIDIA Hopper
(``csrc/bilstm.cu``), and writes the same split outputs in input order.

  io/        host-side streaming FASTQ/FASTA parse + gzip + writers
  encode/    vectorized byte->token encoding
  native/    C++ parser/encoder (fastx.cpp), built with g++ at first use
  models/    BiLSTM parameters as torch tensors + the plain fp32 forward,
             init/save/load helpers, and the .pth/.npz/.onnx converter
  ops/       the CUDA BiLSTM kernels, their build, and device-side glue
  runtime/   streaming pipeline, ensure-mode logic, batching, buckets
  train/     trainer (autograd over the plain forward) and its CLI
  cli.py     `ribodetector`-compatible command line (runs on the card)
"""

__version__ = "0.1.0"
