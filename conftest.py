"""Keep each pytest process under the kernel's memory-map limit.

XLA:CPU maps the machine code of every executable it compiles or loads into
the process (three maps per compiled kernel), and JAX keeps the executables
in its compilation caches for as long as the process lives: a module-level
``jax.jit`` with static arguments keeps one for every configuration a test
gave it. A worker that runs many SLAM tests in a row climbs towards
``vm.max_map_count`` (65530 by default; a SLAM test adds about 6000 maps,
two concurrent tiny SLAM runs about 13000), and the compile or cache load
that crosses it dies with SIGSEGV or SIGABRT inside XLA.

After each test, once the process holds more than half the limit, this drops
JAX's in-memory compilation caches. Arrays and the on-disk compilation cache
stay; the next test compiles or loads again only what it calls.
"""
import sys

import pytest


def _max_map_count():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


_MAP_LIMIT = _max_map_count()


def _maps_in_use():
    with open("/proc/self/maps", "rb") as f:
        return sum(1 for _ in f)


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if _MAP_LIMIT is None or jax is None:
        return
    if _maps_in_use() > _MAP_LIMIT // 2:
        jax.clear_caches()
