"""Interpreter start-up hook for the example scripts' command-line tests
(``tests/test_torch_examples_cli.py`` puts this directory on the
``PYTHONPATH`` of the processes it starts, and so of theirs): float32
subnormals are flushed to zero, as XLA's CPU backend computes. The
Gaussian PSF's tails are float32 subnormals, on which MKL's GEMM runs
about 70 times slower; a served batch took minutes instead of seconds."""
import torch

torch.set_flush_denormal(True)
