"""Worker process of the fiducial-pair searches
(`fiducialpairreduction._SvdWorkers`).

It holds one sensitivity matrix M and answers each request, an index array
[n, rows], with the singular values of the stack M[index] as numpy's LAPACK
gives them.  Requests and answers are pickles on stdin and stdout; EOF on
stdin ends it.  It imports numpy only, so it starts in a fraction of a
second, and its parent gives it one BLAS thread through its environment.
"""

import pickle
import sys

import numpy as np


def main():
    M = None
    while True:
        try:
            msg = pickle.load(sys.stdin.buffer)
        except EOFError:
            return
        if isinstance(msg, tuple):                         # ('matrix', M)
            M = msg[1]
            continue
        pickle.dump(np.linalg.svd(M[msg], compute_uv=False), sys.stdout.buffer,
                    protocol=pickle.HIGHEST_PROTOCOL)
        sys.stdout.buffer.flush()


if __name__ == '__main__':
    main()
