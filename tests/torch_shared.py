"""A module fixture's value computed once per test run and shared by the
pytest-xdist workers.

Under ``--dist load`` a module-scoped fixture runs again on every worker
that draws one of its module's tests, so a fixture that launches gloo
ranks or compiles JAX references would run up to once a worker.
:func:`shared` computes it on the first worker that asks, under a file
lock in the run's base temporary directory (which the workers share),
and the others read the pickle.  Without xdist it just computes.
"""

from __future__ import annotations

import pickle

from filelock import FileLock


def worker_of(request) -> str:
    """The xdist worker id of ``request``'s session, "master" without
    xdist."""
    return getattr(request.config, "workerinput", {}).get("workerid",
                                                          "master")


def shared(request, tmp_path_factory, name: str, compute):
    """``compute()`` once per run under ``name`` (module docstring)."""
    if worker_of(request) == "master":
        return compute()
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        value = compute()
        path.write_bytes(pickle.dumps(value))
        return value


def shared_parts(request, tmp_path_factory, prefix: str,
                 computes: dict) -> dict:
    """Each of ``computes`` (name -> compute) once per run, as ``shared``
    gives it, taken in an order rotated to this worker's share of the
    list: workers that reach the parts at once compute different ones
    side by side instead of queueing on the first."""
    names = list(computes)
    worker = worker_of(request)
    k = 0
    if worker.startswith("gw"):
        count = request.config.workerinput.get("workercount", 1)
        k = int(worker[2:]) * len(names) // max(count, 1) % len(names)
    return {n: shared(request, tmp_path_factory, f"{prefix}_{n}",
                      computes[n]) for n in names[k:] + names[:k]}
