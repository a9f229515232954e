"""Keep each test process to two host threads: the CPU runs below time
their windows by the host clock, and several processes that each take
every core starve one another's ticks."""

import torch

torch.set_num_threads(2)
