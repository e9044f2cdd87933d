"""A JAX package reference computed in a process of its own, beside the
port's run in the test's process: the port's tests overlap the two
instead of running them one after the other."""

import concurrent.futures
import contextlib
import importlib
import multiprocessing


@contextlib.contextmanager
def jax_reference(fn, *args):
    """fn(*args) as a future, run in a spawned process started with the
    suite's JAX settings (tests/conftest.py is imported there first). fn
    is a module-level function of a test module, and its arguments and
    result pickle (numpy, not JAX arrays). The process ends on exit."""
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=importlib.import_module,
            initargs=("conftest",)) as ex:
        yield ex.submit(fn, *args)
