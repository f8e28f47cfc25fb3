"""One reference decode in a process of its own (`check.py`):

    python3 -m port_bench.refworker THREADS < stream > pickled result

The stream comes on standard input; `check.reference_decode`'s result
goes out pickled on standard output, read only by the process that
started this one.
"""
import pickle
import sys

import torch

from port_bench.check import reference_decode

if __name__ == "__main__":
    torch.set_num_threads(int(sys.argv[1]))
    result = reference_decode(sys.stdin.buffer.read())
    sys.stdout.buffer.write(pickle.dumps(result, pickle.HIGHEST_PROTOCOL))
