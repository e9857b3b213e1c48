"""Checkpoint manager with verified restores: the JAX package's
``checkpoint/manager.py`` in the port's own format.

Saves the tensor and counter portion of a ``TrainState`` (``step``,
``params``, the optimizer state, ``batch_stats`` and, under the anomaly
gate, its ``resilience`` counters); the model and the optimizer's
transformations are code, rebuilt by the caller, whose live state is the
template a restore fills.

**Format.**  Under the port's data parallelism the state is replicated
(``parallel/sharding.py::replicate_state``), so rank 0 alone writes.  One
committed step is the directory ``<dir>/<step>/``:

- ``tensors.pt`` — ``torch.save`` of a flat name → tensor dict
  (``params/<name>``, ``batch_stats/<name>``, ``opt_state/<path>``, each
  list of the optimizer state keyed by parameter name), in the logical
  (contiguous) layout;
- ``scalars.json`` — the host counters: ``step`` and every ``count`` in
  the optimizer state (``AdamState.count``, ``CountState.count``) that is
  a host int;
- ``structure.json`` — each tensor's dtype and shape and the counters'
  names: what the template must match.

It is written under ``<dir>/<step>.tmp-<pid>/``, fsynced and committed
by ``os.replace`` — the tmp-dir + rename atomicity of orbax, whose
uncommitted wreckage ``all_steps`` never lists.  Beside each step,
``manifest-<step>.json`` holds every tensor's crc32, dtype and shape and
the payload's size (``checksum_manifest``).  Files load with
``torch.load(..., weights_only=True)``: they hold tensors and plain
values only.

**Async saves.**  The port updates parameters, moments and running
statistics in place, so a writer thread handed the live tensors would
write a torn step (the torn CPU checkpoint the JAX manager's docstring
describes, here on the card as much as on the host).  ``save`` therefore
copies the state into host buffers before it returns: pinned buffers the
manager allocates once and reuses, filled by ``non_blocking`` copies on a
side stream that waits for the compute stream; the compute stream then
waits for the copies' event before the next in-place update.  So the
host does not stall for the copy, but the card does: every kernel queued
after ``save`` starts once the whole state has crossed to the host
(``chip_smoke.py``'s C0 times that wait).  CPU tensors are copied
explicitly.  The writer thread checksums those staged host bytes.  (JAX
skips the manifest for accelerator-resident leaves because checksumming
them would force a second device-to-host fetch; the port's staged copy
is already on the host, so by JAX's own rule the manifest costs no
device traffic and is always written.)  One save is in flight at a
time: a new save first waits for the previous one to commit (orbax does
the same), so a cadence shorter than the commit blocks the host, and a
save that fails raises at the next ``save``, ``wait_until_finished`` or
``close``.

**Restore.**  Rank 0 walks the committed steps newest-first with JAX's
fallback rules, then broadcasts the outcome (the step, "none", or the
error every rank raises) and ``replicate_state`` hands every rank the
restored tensors, so only rank 0's host needs the files and every rank
is bit-identical by construction.  Tensors are ``copy_``-ed into the
live parameters, optimizer tensors and BatchNorm buffers (the modules
hold them; they are never rebound) and the counters are set.

**Counters.**  Under the anomaly gate the optimizer's counts are 0-dim
device tensors (``train/optim.py``) and the gate's ``bad_streak`` and
``skipped_total`` ride the state (``resilience/anomaly.py``); both are
saved as tensors (``opt_state/<path>``, ``resilience/<name>``), staged
with the rest.  A count may therefore be saved in either form and is
restored into whichever form the template holds; a checkpoint without
the resilience counters (one saved without the gate) restores them as 0.
Rank 0 reads every counter as an int and broadcasts them with the
outcome, so all ranks set the same values.  (The JAX package does not
checkpoint its resilience counters; they restart at 0 there.)

**Sharded states** (``state.shardings``, ``parallel/sharded.py``):
every rank takes part in a save, which all-gathers each sharded tensor
to its whole shape, and rank 0 writes the same format as above, so a
sharded run's checkpoint is the replicated one's (the weight bridge's
``train_state_to_jax`` reads either).  A restore checks the template's
whole shapes, then broadcasts each whole tensor from rank 0 and every
rank keeps its part in the template's layout, as JAX restores into the
template's sharding: a save under ``--fsdp 4`` restores under
``--zero1``, plain data parallelism or one process.  (A state too large
for one host's memory would need ``torch.distributed.checkpoint``'s
per-rank files; no configuration here is.)  The pipelined GPT-2 saves
its stacked stage tensors whole (``(S, ...)``, gathered over the
pipeline group); a restore into another stage layout, into the plain
model (world 1 included), or from the plain model's checkpoint into a
pipelined one merges and splits them on rank 0 before the template
check (``parallel/gpt2_pipeline.py::relayout_checkpoint``).

**Not saved:** the two-tier sync's error-feedback residual
(``TrainState.grad_sync_residual``), as in JAX, whose restore keeps the
template's.  A restore leaves the template's residual as it is (the
CLI's: fresh zeros), so a resumed compressed run restarts its error
feedback.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable

import torch

TENSORS = "tensors.pt"
SCALARS = "scalars.json"
STRUCTURE = "structure.json"


def _walk(tree: Any, path: str, names: list[str], tensors: dict,
          counts: dict) -> None:
    """Flatten an optimizer state (``train/optim.py``: tuples, dataclasses
    and per-parameter lists): tensors by path, int counters by path.
    Lists are the per-parameter slots (moments, momentum), keyed by the
    parameter's name."""
    if isinstance(tree, torch.Tensor):
        tensors[path] = tree
    elif isinstance(tree, int):
        counts[path] = tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _walk(getattr(tree, f.name), f"{path}/{f.name}", names, tensors,
                  counts)
    elif isinstance(tree, tuple):
        for i, item in enumerate(tree):
            _walk(item, f"{path}/{i}", names, tensors, counts)
    elif isinstance(tree, list):
        if len(tree) != len(names):
            raise ValueError(f"{path}: {len(tree)} slots for "
                             f"{len(names)} parameters")
        for name, item in zip(names, tree):
            _walk(item, f"{path}/{name}", names, tensors, counts)


def flatten_state(state) -> tuple[dict[str, torch.Tensor], dict[str, int]]:
    """``(tensors, scalars)`` of a ``TrainState``: every tensor by its
    checkpoint name (the gate's counters as ``resilience/<name>``), and
    ``step`` with every optimizer counter that is a host int."""
    tensors = {f"params/{n}": t for n, t in state.params.items()}
    tensors.update({f"batch_stats/{n}": t
                    for n, t in state.batch_stats.items()})
    counts: dict[str, int] = {}
    _walk(state.opt_state, "opt_state", list(state.params), tensors, counts)
    if dataclasses.is_dataclass(state.resilience):
        for f in dataclasses.fields(state.resilience):
            tensors[f"resilience/{f.name}"] = getattr(state.resilience,
                                                      f.name)
    return tensors, {"step": int(state.step), **counts}


def _is_counter(name: str, t) -> bool:
    """An optimizer count or a resilience counter: state that restores
    as an int, whichever form it was saved in."""
    if not isinstance(t, torch.Tensor):
        return True
    return name.startswith("resilience/") or (
        name.startswith("opt_state/") and t.dim() == 0
        and not t.is_floating_point())


def split_counters(tensors: dict, scalars: dict) -> tuple[dict, dict]:
    """``(tensors, counters)``: the tensors that are neither counts nor
    resilience counters, and those counters (ints or 0-dim tensors) with
    ``step``, by name."""
    rest = {n: t for n, t in tensors.items() if not _is_counter(n, t)}
    counters = {**scalars, **{n: t for n, t in tensors.items()
                              if _is_counter(n, t)}}
    return rest, counters


def set_counters(state, counters: dict):
    """``state`` with ``step``, every optimizer count and the resilience
    counters set from ``counters`` (name -> int); a resilience counter
    missing from it becomes 0.  Tensors are filled in place."""
    names = list(state.params)
    opt_state = _set_counts(state.opt_state, "opt_state", names, counters)
    if dataclasses.is_dataclass(state.resilience):
        for f in dataclasses.fields(state.resilience):
            getattr(state.resilience, f.name).fill_(
                counters.get(f"resilience/{f.name}", 0))
    return dataclasses.replace(state, step=int(counters["step"]),
                               opt_state=opt_state)


def _set_counts(tree: Any, path: str, names: list[str],
                counts: dict) -> Any:
    """``tree`` with every counter replaced from ``counts``: host ints
    swapped, 0-dim tensors filled (in place for dataclasses; tuples are
    rebuilt)."""
    if isinstance(tree, torch.Tensor):
        if path in counts and tree.dim() == 0:
            tree.fill_(int(counts[path]))
        return tree
    if isinstance(tree, int):
        return counts[path]
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            setattr(tree, f.name, _set_counts(
                getattr(tree, f.name), f"{path}/{f.name}", names, counts))
        return tree
    if isinstance(tree, tuple):
        return tuple(_set_counts(item, f"{path}/{i}", names, counts)
                     for i, item in enumerate(tree))
    return tree    # a list of per-parameter tensors


def _whole_shapes(state) -> dict:
    """Each tensor entry's whole (logical) shape, by checkpoint name."""
    want = split_counters(*flatten_state(state))[0]
    layout = getattr(state, "shardings", None)
    return {n: (tuple(t.shape) if layout is None
                else layout.full_shape(n, t)) for n, t in want.items()}


def _relayout(tensors: dict, template) -> dict:
    """A GPT-2 checkpoint saved under another pipeline stage layout (or
    the plain model's) in ``template``'s
    (``parallel/gpt2_pipeline.py::relayout_checkpoint``); any other
    checkpoint as it is."""
    if "params/wte" not in tensors:
        return tensors
    from ..parallel.gpt2_pipeline import relayout_checkpoint

    return relayout_checkpoint(tensors, _whole_shapes(template))


def _host_bytes(t: torch.Tensor):
    """The logical (contiguous) bytes of a host tensor, without a copy
    when it is contiguous already."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def checksum_manifest(tensors: dict[str, torch.Tensor]) -> dict[str, dict]:
    """Per-tensor crc32/dtype/shape of host tensors' logical bytes — the
    record ``restore_latest`` verifies a restored step against."""
    return {name: {"crc32": zlib.crc32(_host_bytes(t)),
                   "dtype": str(t.dtype).removeprefix("torch."),
                   "shape": list(t.shape)}
            for name, t in tensors.items()}


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointCorrupted(RuntimeError):
    """A committed checkpoint failed manifest verification."""


class CheckpointManager:
    """Async by default: ``save`` stages the state to host memory and
    returns; serialization to disk overlaps the following steps.  A crash
    mid-save leaves an uncommitted tmp directory that ``restore_latest``
    ignores, so the previous committed step is what restores.  Usable as
    a context manager; exiting (or ``close``) waits for in-flight saves
    to commit, so every CLI exit path — normal, exception, SIGTERM
    preemption — lands with the final save on disk.

    ``on_anomaly(kind, **fields)`` (optional) receives integrity events
    (``checkpoint_restore_failed``).  ``fault_injector`` (optional,
    ``resilience/faults.py``) gets ``on_checkpoint_saved`` callbacks so
    ``ckpt_truncate@N`` chaos can corrupt a *committed* checkpoint
    deterministically.  ``process_group``: the data-parallel group; its
    rank 0 writes and reads, the other ranks only take part in the
    restore's broadcasts.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 on_anomaly: Callable[..., None] | None = None,
                 fault_injector=None, process_group: Any = None):
        import torch.distributed as dist

        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.on_anomaly = on_anomaly
        self.fault_injector = fault_injector
        self.group = process_group
        self.rank = (dist.get_rank(process_group)
                     if process_group is not None else 0)
        self._last_saved_step: int | None = None
        # Steps that failed to DESERIALIZE during a restore this process
        # ran (not checksum-proven corrupt, so not deleted): a re-save at
        # the same counter replaces them instead of deduping against the
        # unreadable bytes.
        self._bad_steps: set[int] = set()
        self._buffers: dict[str, torch.Tensor] = {}
        self._stream = None
        self._copied = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        if self.rank == 0:
            os.makedirs(self.directory, exist_ok=True)

    def _anomaly(self, kind: str, **fields) -> None:
        if self.on_anomaly is not None:
            self.on_anomaly(kind, **fields)

    # ---- save -----------------------------------------------------------

    def save(self, state, *, step: int | None = None,
             wait: bool = False) -> None:
        """Stage ``state`` to host memory and commit it as ``step``
        (default ``state.step``) in the background; ``wait`` blocks until
        it has committed.  Ranks other than 0 return at once, after the
        gather of a sharded state (collective: every rank calls it)."""
        layout = getattr(state, "shardings", None)
        if layout is not None:
            tensors, scalars = flatten_state(state)
            with torch.no_grad():
                whole = {n: layout.gather_full(n, t)
                         for n, t in tensors.items()}
        if self.rank != 0:
            return
        step = int(state.step) if step is None else step
        if step in self._bad_steps:
            # The resumed run re-reached a step whose committed bytes
            # failed to deserialize at restore: replace them.
            self._bad_steps.discard(step)
            self._drop_bad_step(step)
        # Dedupe: step-cadence and epoch-end saves can land on the same
        # optimizer step (per_epoch % ckpt_every == 0); the bytes would be
        # identical anyway.
        if step == self._last_saved_step or step in self.all_steps():
            return
        # The staging buffers are reused: the previous write must be done
        # reading them.
        self.wait_until_finished()
        if layout is None:
            tensors, scalars = flatten_state(state)
        else:
            tensors = whole
        scalars["step"] = step
        staged = self._stage(tensors)
        self._last_saved_step = step
        self._thread = threading.Thread(
            target=self._write_guarded,
            args=(step, staged, scalars, self._copied),
            name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        if wait:
            self.wait_until_finished()
        if self.fault_injector is not None:
            self.fault_injector.on_checkpoint_saved(self, step)

    def _stage(self, tensors: dict[str, torch.Tensor]
               ) -> dict[str, torch.Tensor]:
        """Copy ``tensors`` into the reused host buffers (pinned for CUDA
        sources); returns the buffers.  CUDA copies run on a side stream
        after the compute stream's pending work, and the compute stream
        waits for their event before anything later touches the state."""
        if set(self._buffers) != set(tensors) or any(
                self._buffers[n].shape != t.shape
                or self._buffers[n].dtype != t.dtype
                for n, t in tensors.items()):
            self._buffers = {
                n: torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                for n, t in tensors.items()}
        self._copied = None
        on_card = [n for n, t in tensors.items() if t.is_cuda]
        with torch.no_grad():
            if on_card:
                device = tensors[on_card[0]].device
                compute = torch.cuda.current_stream(device)
                if self._stream is None or self._stream.device != device:
                    self._stream = torch.cuda.Stream(device)
                self._stream.wait_stream(compute)
                with torch.cuda.stream(self._stream):
                    for n in on_card:
                        self._buffers[n].copy_(tensors[n], non_blocking=True)
                    self._copied = torch.cuda.Event()
                    self._copied.record(self._stream)
                compute.wait_event(self._copied)
            for n, t in tensors.items():
                if not t.is_cuda:
                    self._buffers[n].copy_(t)
        return self._buffers

    def _write_guarded(self, *job) -> None:
        try:
            self._write(*job)
        except BaseException as e:  # re-raised by wait_until_finished
            self._error = e

    def _write(self, step: int, staged: dict, scalars: dict,
               copied) -> None:
        if copied is not None:
            copied.synchronize()
        tmp = os.path.join(self.directory, f"{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        payload = os.path.join(tmp, TENSORS)
        torch.save(staged, payload)
        _fsync(payload)
        _write_json(os.path.join(tmp, SCALARS), scalars)
        _write_json(os.path.join(tmp, STRUCTURE), {
            "tensors": {n: {"dtype": str(t.dtype).removeprefix("torch."),
                            "shape": list(t.shape)}
                        for n, t in staged.items()},
            "scalars": sorted(scalars)})
        _fsync(tmp)
        # The manifest lands before the commit, so a committed step always
        # has one; a manifest left by a crash before the rename belongs to
        # no step and is pruned below.
        manifest = self._manifest_path(step)
        _write_json(manifest + ".tmp", {
            "step": step, "leaves": checksum_manifest(staged),
            "files": {TENSORS: os.path.getsize(payload)}})
        os.replace(manifest + ".tmp", manifest)
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync(self.directory)
        self._retire()

    def _retire(self) -> None:
        """Keep the newest ``max_to_keep`` steps; prune the manifests of
        steps that no longer exist."""
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            self._drop_bad_step(s)
        live = set(self.all_steps())
        for name in os.listdir(self.directory):
            if name.startswith("manifest-") and name.endswith(".json"):
                try:
                    s = int(name[len("manifest-"):-len(".json")])
                except ValueError:
                    continue
                if s not in live:
                    os.remove(os.path.join(self.directory, name))

    def wait_until_finished(self) -> None:
        """Block until the in-flight save has committed; raise its error
        if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        """Commit the in-flight save: the exit half of the
        context-manager lifecycle."""
        self.wait_until_finished()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- steps and manifests --------------------------------------------

    def all_steps(self) -> list[int]:
        """The committed steps, oldest first (tmp directories excluded)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest-{step}.json")

    def _drop_bad_step(self, step: int) -> bool:
        """Remove a committed step (+ its manifest).  The manifest goes
        ONLY with the step: removing it while the step survives (delete
        failed — read-only FS, lock) would turn a DETECTED-corrupt
        checkpoint into one that verifies vacuously on the next
        relaunch."""
        try:
            shutil.rmtree(os.path.join(self.directory, str(step)))
            deleted = True
        except OSError:
            deleted = False
        if deleted:
            manifest = self._manifest_path(step)
            if os.path.exists(manifest):
                os.remove(manifest)
        return deleted

    def manifest(self, step: int) -> dict | None:
        """The manifest of a committed step (None without one): ``step``,
        each tensor's crc32/dtype/shape under ``leaves`` and the
        payload's size in bytes under ``files``."""
        if not os.path.exists(self._manifest_path(step)):
            return None
        with open(self._manifest_path(step)) as f:
            return json.load(f)

    def load_tensors(self, step: int) -> dict[str, torch.Tensor]:
        """Every tensor of a committed step by its checkpoint name
        (``params/<name>``, ``batch_stats/<name>``, ``opt_state/<path>``),
        on the host and unverified."""
        return torch.load(os.path.join(self.directory, str(step), TENSORS),
                          map_location="cpu", weights_only=True)

    def _load(self, step: int) -> tuple[dict, dict, dict | None]:
        """(tensors, scalars, manifest or None) of a committed step.  A
        payload whose size differs from the manifest's record is
        checksum-proven corruption (truncation), raised before loading."""
        step_dir = os.path.join(self.directory, str(step))
        manifest = self.manifest(step)
        if manifest is not None:
            payload = os.path.join(step_dir, TENSORS)
            want = manifest.get("files", {}).get(TENSORS)
            if want is not None and os.path.exists(payload) \
                    and os.path.getsize(payload) != want:
                raise CheckpointCorrupted(
                    f"step {step}: {TENSORS} is "
                    f"{os.path.getsize(payload)} bytes, the manifest "
                    f"recorded {want}")
        tensors = self.load_tensors(step)
        with open(os.path.join(step_dir, SCALARS)) as f:
            scalars = json.load(f)
        return tensors, scalars, manifest

    @staticmethod
    def _verify(step: int, manifest: dict | None, tensors: dict,
                names=None) -> None:
        """Compare loaded bytes against the step's manifest (``names``:
        only those tensors).  No manifest verifies vacuously.

        Raises :class:`CheckpointCorrupted` ONLY for bit-rot evidence —
        a tensor present on both sides with matching dtype/shape whose
        bytes changed.  Structural differences (missing/extra tensors,
        dtype/shape drift) raise a plain ValueError, so the restore
        fallback never treats a good checkpoint as destroyably corrupt."""
        if manifest is None:
            return
        want = manifest["leaves"]
        got = checksum_manifest(
            tensors if names is None else {n: tensors[n] for n in names})
        keys = set(want) if names is None else set(names)
        structural = sorted(keys ^ set(got)) + sorted(
            k for k in keys & set(got)
            if (want[k]["dtype"], want[k]["shape"])
            != (got[k]["dtype"], got[k]["shape"]))
        if structural:
            raise ValueError(
                f"step {step}: manifest/payload structure mismatch on "
                f"{len(structural)} tensors (first: {structural[0]})")
        bad = sorted(k for k in keys if want[k]["crc32"] != got[k]["crc32"])
        if bad:
            raise CheckpointCorrupted(
                f"step {step}: {len(bad)} tensors fail checksum "
                f"(first: {bad[0]})")

    @staticmethod
    def _match(step: int, tensors: dict, scalars: dict, template) -> None:
        """Raise ValueError unless the step has the template's tensors
        (names, dtypes, shapes) and optimizer counts (in either form; the
        resilience counters are optional): a config change, not
        corruption."""
        want, want_counters = split_counters(*flatten_state(template))
        shapes = _whole_shapes(template)
        tensors, counters = split_counters(tensors, scalars)
        diff = sorted(set(want) ^ set(tensors)) + sorted(
            n for n in set(want) & set(tensors)
            if (want[n].dtype, shapes[n])
            != (tensors[n].dtype, tuple(tensors[n].shape)))
        diff += sorted(
            {n for n in set(want_counters) ^ set(counters)
             if not n.startswith("resilience/")})
        if diff:
            raise ValueError(
                f"step {step}: checkpoint/template structure mismatch on "
                f"{len(diff)} entries (first: {diff[0]}) — a config change, "
                "not corruption")

    # ---- restore --------------------------------------------------------

    def _walk_restore(self, template):
        """Rank 0's newest-first walk: ``(step, tensors, scalars)`` of the
        newest step that loads, matches ``template`` and verifies; None
        when there is no committed step; raises RuntimeError when every
        committed step fails."""
        steps = sorted(self.all_steps(), reverse=True)
        errors: list[str] = []
        for step in steps:
            try:
                saved, scalars, manifest = self._load(step)
                tensors = _relayout(saved, template)
                self._match(step, tensors, scalars, template)
                self._verify(step, manifest, saved)
            except CheckpointCorrupted as e:
                # Checksum-proven bit-rot: independent evidence the disk
                # bytes changed, so the step is safe to drop — it must
                # not shadow the good older step as "latest" or block
                # its own re-save via the duplicate-step dedupe.
                deleted = self._drop_bad_step(step)
                errors.append(f"step {step}: {e}")
                self._anomaly("checkpoint_restore_failed", step=step,
                              error=f"CheckpointCorrupted: {e}",
                              deleted=deleted)
                continue
            except Exception as e:
                # Anything else — an unreadable payload, a template
                # mismatch, transient I/O — is NOT proof the checkpoint is
                # bad, so never delete on it (a template mismatch would
                # destroy the whole good history newest-first).  Remember
                # the step so a re-save at the same counter replaces it.
                self._bad_steps.add(step)
                errors.append(f"step {step}: {type(e).__name__}: {e}")
                self._anomaly("checkpoint_restore_failed", step=step,
                              error=f"{type(e).__name__}: {e}",
                              deleted=False)
                continue
            return step, tensors, scalars
        if steps:
            raise RuntimeError(
                f"no committed checkpoint under {self.directory} could be "
                f"restored ({len(steps)} candidates): " + "; ".join(errors))
        return None

    def restore_latest(self, template):
        """Restore the newest VERIFIED checkpoint into ``template`` (the
        live ``TrainState``); returns it with the restored step, or None
        when the directory holds no committed step at all (a fresh run).

        Steps are tried newest-first; one that fails its manifest (a
        checksum, or a payload of another size than committed) is
        reported (``on_anomaly`` ``checkpoint_restore_failed``), DELETED
        and skipped; one that fails otherwise (unreadable, or a
        structure other than the template's) is reported, kept and
        skipped.  When committed steps exist but EVERY one fails — almost
        always a changed model/optimizer config under ``--resume``, not
        bit-rot — it raises RuntimeError rather than train from scratch
        and retire the good checkpoints.

        The checkpoint is topology-free: saved at one world size, it
        restores at any other (the state is replicated)."""
        import torch.distributed as dist

        from ..parallel.sharding import replicate_state

        outcome = found = error = None
        if self.rank == 0:
            try:
                found = self._walk_restore(template)
                outcome = ("none",) if found is None else ("step", {
                    n: int(v) for n, v in
                    split_counters(found[1], found[2])[1].items()})
            except Exception as e:
                # Every rank must hear of it: a rank 0 that raised before
                # the broadcast would leave the others waiting in it.
                error = e
                outcome = ("error", f"{type(e).__name__}: {e}")
        if self.group is not None:
            box = [outcome]
            dist.broadcast_object_list(box, src=0, group=self.group)
            outcome = box[0]
        if error is not None:
            raise error
        if outcome[0] == "error":
            raise RuntimeError(f"rank 0's restore failed: {outcome[1]}")
        if outcome[0] == "none":
            return None
        layout = getattr(template, "shardings", None)
        if layout is not None:
            self._scatter(template, layout, found)
            return set_counters(template, outcome[1])
        if found is not None:
            tensors = split_counters(*flatten_state(template))[0]
            with torch.no_grad():
                for name, live in tensors.items():
                    live.copy_(found[1][name])
        if self.group is not None:
            replicate_state(template, self.group)
        return set_counters(template, outcome[1])

    def _scatter(self, template, layout, found) -> None:
        """Each whole tensor broadcast from rank 0, each rank keeping its
        part in ``template``'s layout (collective)."""
        from ..comm import collectives

        tensors = split_counters(*flatten_state(template))[0]
        with torch.no_grad():
            for name, live in tensors.items():
                if found is not None:
                    whole = found[1][name].to(live.device)
                else:
                    whole = torch.empty(layout.full_shape(name, live),
                                        dtype=live.dtype, device=live.device)
                if self.group is not None:
                    collectives.broadcast([whole], self.group)
                live.copy_(layout.shard_full(name, live, whole))

    def restore_params(self) -> dict[str, torch.Tensor] | None:
        """The ``params`` of the newest checkpoint as a name → host tensor
        dict (None when the directory holds no committed step).

        The serving path wants the trained weights and nothing else, so
        no template is needed.  Corrupt newer steps fall back as in
        :meth:`restore_latest` (params checksums only — the manifest's
        other entries cover state the serving path never touches)."""
        for step in sorted(self.all_steps(), reverse=True):
            try:
                tensors, _, manifest = self._load(step)
                names = [n for n in tensors if n.startswith("params/")]
                self._verify(step, manifest, tensors, names)
            except Exception as e:
                self._anomaly("checkpoint_restore_failed", step=step,
                              error=f"{type(e).__name__}: {e}")
                continue
            return {n[len("params/"):]: tensors[n] for n in names}
        return None
