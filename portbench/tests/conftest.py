"""The benchmark's tests run several workers (the repository's pytest
settings): one thread of CPU math each keeps them from crowding the
cores."""
import torch

torch.set_num_threads(1)
