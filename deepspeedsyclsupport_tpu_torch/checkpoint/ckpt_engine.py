"""Pluggable checkpoint engines.

Port of ``deepspeedsyclsupport_tpu/checkpoint/ckpt_engine.py``: the
synchronous engine over ``save_tree`` / ``load_tree`` (durable when
``save`` returns) and the asynchronous one (the reference's Nebula engine),
whose ``save`` returns once the state is copied to the host and whose
worker thread writes it into a ``.staging-<tag>`` directory, renames that
onto the tag when complete and moves the ``latest`` pointer only after
that, so a crash mid-save never leaves ``latest`` naming a torn
checkpoint.

The async engine's copy is the hazard the JAX engine meets with donation:
the port's optimizer updates the master params and moments IN PLACE, so a
view, or a ``non_blocking`` copy not yet finished, would let the writer
save a later step's bytes. Every leaf is copied device -> pinned host
memory, then the copies are waited for (``torch.cuda.synchronize``) before ``save`` returns; a CPU
leaf is cloned. Only then does the writer thread start.
"""
import os
import shutil
import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.fault_injection import get_fault_injector
from ..utils.logging import logger

__all__ = ["CheckpointEngine", "NativeCheckpointEngine",
           "AsyncCheckpointEngine", "build_checkpoint_engine",
           "sweep_staging_dirs"]


class CheckpointEngine(ABC):
    """save / load / commit surface (reference ``checkpoint_engine.py``)."""

    name = "base"

    @abstractmethod
    def save(self, path: str, state: Any, meta: Dict[str, Any],
             latest_file: Optional[str] = None, tag: str = "",
             post_commit: Optional[Callable[[], None]] = None) -> None:
        """Persist ``state`` + ``meta`` under ``path``; point
        ``latest_file`` at ``tag`` once durable, then run ``post_commit``
        (the rotation hook; on the async engine's worker thread)."""

    @abstractmethod
    def load(self, path: str, template: Any, device=None
             ) -> Tuple[Any, Dict[str, Any]]:
        ...

    def commit(self, tag: str = "") -> bool:
        """Seal a tag: True once every pending write for it is durable."""
        self.wait()
        return True

    def wait(self) -> None:
        """Block until every save in flight is durable."""


def _write_latest(latest_file: Optional[str], tag: str) -> None:
    """Atomically repoint ``latest`` (temp file, fsync, ``os.replace``):
    an in-place write torn by a crash would name no tag. Pod rank 0
    only."""
    from ..utils.podid import pod_rank

    if latest_file and pod_rank() == 0:
        from .engine import _durable_write

        _durable_write(latest_file + ".tmp", tag,
                       what=f"latest-pointer update {latest_file}",
                       rename_to=latest_file)


def _run_post_commit(post_commit: Optional[Callable[[], None]]) -> None:
    if post_commit is None:
        return
    try:
        post_commit()
    except Exception as e:  # rotation must never fail a durable save
        logger.warning("checkpoint post-commit hook failed: %s", e)


def sweep_staging_dirs(directory: str, keep: Optional[str] = None,
                       deep: bool = True) -> int:
    """Clean up what a killed save left behind. A torn-pod tag (rank
    manifests without a matching commit record) is quarantined. A
    ``.staging-*`` orphan that verifies complete, whose tag is absent or
    torn, is promoted (the interrupted rename is finished: it may be the
    only copy of the newest checkpoint); every other orphan is removed.
    Runs at resume time, when no save is in flight. ``deep=False``
    verifies structure and sizes only. Returns the number handled."""
    from .engine import (_QUARANTINE_RE, is_torn_pod, quarantine_tag,
                         verify_tree)
    from ..monitor.monitor import resilience_counters

    handled = promoted = quarantined = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        p = os.path.join(directory, name)
        if name.startswith(".staging") or _QUARANTINE_RE.search(name) \
                or not os.path.isdir(p) or p == keep:
            continue
        if is_torn_pod(p):
            try:
                dst = quarantine_tag(p)
            except OSError as e:  # the verify gate still skips it
                logger.warning("could not quarantine torn-pod tag %s: %s",
                               p, e)
                continue
            logger.warning("quarantined torn-pod checkpoint %s -> %s (rank "
                           "manifests without a matching pod commit)", p, dst)
            quarantined += 1
    if quarantined:
        resilience_counters.incr("torn_pod_quarantined", quarantined)
    for name in names:
        p = os.path.join(directory, name)
        if not (name.startswith(".staging") and os.path.isdir(p)
                and p != keep):
            continue
        target = os.path.join(directory, name[len(".staging-"):])
        promotable = (name.startswith(".staging-") and name != ".staging-"
                      and verify_tree(p, deep=deep)[0])
        if promotable and os.path.exists(target) \
                and not verify_tree(target, deep=deep)[0]:
            # the tag is a wreck and the staging copy is whole: move the
            # wreck aside so the copy can take its place
            try:
                quarantine_tag(target)
            except OSError as e:
                logger.warning("could not quarantine torn tag %s; keeping "
                               "%s for a later sweep: %s", target, p, e)
                continue
        if promotable and not os.path.exists(target):
            try:
                os.replace(p, target)
                logger.warning("promoted complete checkpoint staging dir "
                               "%s -> %s", p, target)
                handled += 1
                promoted += 1
                continue
            except OSError as e:
                logger.warning("could not promote staging dir %s: %s", p, e)
        shutil.rmtree(p, ignore_errors=True)
        logger.warning("swept orphaned checkpoint staging dir %s", p)
        handled += 1
    if handled:
        resilience_counters.incr("staging_sweeps", handled - promoted)
        if promoted:
            resilience_counters.incr("staging_promotions", promoted)
    return handled + quarantined


class NativeCheckpointEngine(CheckpointEngine):
    """Synchronous engine over ``save_tree`` / ``load_tree``."""

    name = "native"

    def save(self, path, state, meta, latest_file=None, tag="",
             post_commit=None):
        from .engine import save_tree

        save_tree(path, state, meta)
        _write_latest(latest_file, tag)
        _run_post_commit(post_commit)

    def load(self, path, template, device=None):
        from .engine import load_tree

        return load_tree(path, template, device=device)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background-thread engine: ``save`` returns after the host copy (see
    the module docstring); serialization and fsync happen on a worker. One
    save in flight: a new save waits for the previous one."""

    name = "async"

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @staticmethod
    def _host_copy(leaves):
        """Host copies of ``leaves`` that nothing else aliases: a device
        tensor goes into pinned memory, and the copies are waited for
        before this returns."""
        out, on_card = [], False
        for leaf in leaves:
            if callable(leaf):
                leaf = leaf()
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach()
                if leaf.device.type == "cuda":
                    buf = torch.empty(leaf.shape, dtype=leaf.dtype,
                                      pin_memory=True)
                    buf.copy_(leaf, non_blocking=True)
                    on_card = True
                    out.append(buf)
                else:
                    out.append(leaf.clone())
            else:
                out.append(np.array(leaf, copy=True))
        if on_card:
            torch.cuda.synchronize()
        return out

    def save(self, path, state, meta, latest_file=None, tag="",
             post_commit=None):
        from .engine import save_tree, verify_tree
        from ..utils.podid import pod_identity

        if pod_identity()[1] > 1:
            # the pod commit waits for its siblings' manifests in the FINAL
            # tag dir, which a worker staging elsewhere never writes
            logger.warning("async checkpoint engine degrades to synchronous "
                           "saves under multi-rank execution")
            save_tree(path, state, meta)
            _write_latest(latest_file, tag)
            _run_post_commit(post_commit)
            return
        self.wait()  # one save in flight; surfaces a prior failure
        # a worker killed mid-save left a .staging-* orphan: sweep it, by
        # structure and size only (this runs on the training thread)
        sweep_staging_dirs(os.path.dirname(os.path.abspath(path)),
                           deep=False)
        from .engine import _flatten, _unflatten

        host_state = _unflatten(state, iter(self._host_copy(
            [leaf for _, leaf in _flatten(state)])))
        staging = os.path.join(os.path.dirname(path),
                               f".staging-{os.path.basename(path)}")

        def work():
            try:
                get_fault_injector().maybe_delay_async()
                if os.path.isdir(staging):
                    shutil.rmtree(staging)
                save_tree(staging, host_state, meta)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                os.replace(staging, path)
                _write_latest(latest_file, tag)
                _run_post_commit(post_commit)
                logger.info("async checkpoint %s durable", path)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e
                # the target may be a partly deleted old tag: only a
                # verified one makes the staging copy redundant
                target_ok = os.path.isdir(path) and verify_tree(path)[0]
                if os.path.isdir(staging) and not target_ok \
                        and verify_tree(staging)[0]:
                    logger.warning("async save of %s failed after a complete "
                                   "staging write; keeping %s for promotion",
                                   path, staging)
                else:
                    shutil.rmtree(staging, ignore_errors=True)

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="dstpu-ckpt-writer")
        self._thread.start()

    def load(self, path, template, device=None):
        from .engine import load_tree

        self.wait()  # never read a tag still being written
        return load_tree(path, template, device=device)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


def build_checkpoint_engine(kind: str) -> CheckpointEngine:
    engines = {"native": NativeCheckpointEngine,
               "async": AsyncCheckpointEngine}
    if kind not in engines:
        raise ValueError(f"unknown checkpoint engine {kind!r} "
                         f"(have {sorted(engines)})")
    return engines[kind]()
