"""One intra-op thread for torch in the port's CPU tests.

The suite runs under ``pytest -n 6`` on a few cores: a full intra-op pool
in every worker oversubscribes them, and the tests' small tensors gain
nothing from it.  Importing this module (the port's test files do, the
card tests in ``test_torch_cuda.py`` do not) sets the count once per
process.
"""
import torch

torch.set_num_threads(1)
