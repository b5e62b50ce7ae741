"""cProfile decorator (counterpart of pygsti_tpu/tools/profile.py).  The
reference keys dump filenames by MPI rank; here the rank is that of the
default torch.distributed process group when one is initialized, else 0."""

import cProfile as _cProfile


def _rank():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def profile(filename=None, comm=None):
    """Decorator profiling a function with cProfile. With `filename`, stats
    dump to '<filename>.out.<rank>'; otherwise they print. `comm` is
    accepted for the reference's signature (the rank comes from
    torch.distributed)."""
    def prof_decorator(f):
        def wrap_f(*args, **kwargs):
            pr = _cProfile.Profile()
            pr.enable()
            result = f(*args, **kwargs)
            pr.disable()
            if filename is None:
                pr.print_stats()
            else:
                pr.dump_stats('{}.out.{}'.format(filename, _rank()))
            return result
        return wrap_f
    return prof_decorator
