"""pytest plugin: collect the PyTorch port's tests before the reference's.

Each ``tests/test_torch_*.py`` module loads it through ``pytest_plugins``.
pytest-xdist's load scheduler refills a worker with about
``pending // (2 * workers)`` tests at a time, so the more tests are
collected behind a module, the more of that module one worker takes in
one go.  The port's files sort after ``tests/test_serve_continuous.py``.
Behind them that module's tests reach one worker together, and together
they compile enough XLA:CPU programs to exhaust the process's memory
maps (Linux's default ``vm.max_map_count`` is 65,530): the worker
crashes inside ``backend_compile_and_load`` around the module's sixth or
seventh test, as the file usually does when run alone.  Collected first,
the port's tests leave the reference suite's tail the chunks it is
handed without them.  The reference tests keep their relative order.

It also runs the port's PyTorch operations on one thread in every
process that loads it.  Each xdist worker would otherwise start an
intra-op pool of one thread per core: six workers on eight cores spin
those pools against each other and against XLA's, and the port's small
CPU operations ran 3 to 20 times slower inside the suite than alone
(``tests/test_torch_flash.py`` took 228 s under ``-n 6``, 82 s with one
thread a worker).  The tests check the same things on one thread.
"""
from __future__ import annotations

import torch

PORT_FILES = "test_torch_"

torch.set_num_threads(1)


def pytest_collection_modifyitems(items):
    items.sort(key=lambda item: not item.path.name.startswith(PORT_FILES))
