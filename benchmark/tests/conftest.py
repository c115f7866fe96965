import os
import sys

# the checkout's root, so that ``benchmark`` and the program import
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

# one thread: the tiny runs are then deterministic (f32 sums in a fixed
# order), and the tests take no more than their share of the machine
torch.set_num_threads(1)
