"""Checkpoints: metric-keyed top-k retention and full resume, as
``torch.save`` files. The port of ``floodplanet_code_tpu/train/checkpoint.py``.

Reference behavior (fit.py:80-85): keep the ``save_topk_models`` best
checkpoints by ``val_MulticlassJaccardIndex`` (mode max); plus the JAX
package's resume from the latest full checkpoint. Layout, the JAX
package's: one directory per entry under ``<exp>/checkpoints``, named
``model-epoch=NN-val_MulticlassJaccardIndex=0.xxxx``, holding
``metrics.json`` and one ``checkpoint.pt``::

    {"model": model state dict, "optimizer": optimizer state dict,
     "step": int, "ema_params": {name: tensor} or None}

A slim entry (a top-k epoch that is not a resume point) leaves out
"optimizer" and carries ``slim_checkpoint.json``. ``index.json`` lists the
kept entries and the latest full one. Tensors are written from host copies.

More than one process (JAX ``:105``, ``:128-142``, ``:248``): the state is
the same on every rank, so rank 0 alone decides and writes, synchronously,
and ``save`` returns at once on the other ranks. Every rank reads the index
from the shared directory only after a barrier that follows rank 0's
write (``_settled_index``: ``fit_model`` holds one after every save), so
``best_model_path``, ``latest_model_path`` and ``latest_epoch`` agree on
every rank, and every rank restores from that directory. ``index.json``
is replaced whole (a temporary file renamed over it): no reader sees it
half written.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from floodplanet_code_tpu_torch.parallel import multihost
from floodplanet_code_tpu_torch.train.state import TrainState
from floodplanet_code_tpu_torch.utils import trace

MONITOR_KEY = "val_MulticlassJaccardIndex"

# Marker file of a slim (eval-only) checkpoint: no optimizer moments, ~3x
# fewer bytes with Adam. Resume points and the final epoch always save full.
SLIM_MARKER = "slim_checkpoint.json"
CHECKPOINT_FILE = "checkpoint.pt"


def lookup_metric(metrics: dict, name: str, default=None):
    """Read a metric tolerating old/new torchmetrics key names.

    The reference accepts both ``test_F1Score`` and ``test_MulticlassF1Score``
    when reading metric dicts (predict.py:245-250); foreign metrics.json files
    may use either convention.
    """
    if name in metrics:
        return metrics[name]
    alt = name.replace("Multiclass", "")
    if alt != name and alt in metrics:
        return metrics[alt]
    prefix, _, bare = name.rpartition("_")
    alt = f"{prefix}_Multiclass{bare}" if prefix else f"Multiclass{bare}"
    if alt in metrics:
        return metrics[alt]
    return default


class CheckpointManager:
    """Top-k best + latest checkpoint retention under ``<exp>/checkpoints``.

    ``async_save=True`` moves the device->host copy, the file write, the
    side files and the retention deletes onto one background worker
    thread, overlapping them with the next epoch's training. The train step
    updates the state in place, so ``save`` first clones every tensor on the
    card (on the current stream, before it returns) and records an event
    after the clones; the worker waits on that event before copying to the
    host. At most one write is in flight: ``save`` drains the previous one
    first, which also re-raises its error at the save site. Every reader
    of the index (``best_model_path``, ``latest_model_path``,
    ``latest_epoch``, ``restore``) drains pending writes first. Under more
    than one process the save is synchronous and rank 0's alone (module
    docstring).
    """

    def __init__(
        self,
        exp_dir: str,
        save_top_k: int = 3,
        monitor: str = MONITOR_KEY,
        async_save: bool = True,
        resume_every: int = 1,
    ):
        self.ckpt_dir = os.path.join(os.path.abspath(exp_dir), "checkpoints")
        self._multi = multihost.process_count() > 1
        self._coordinator = multihost.is_coordinator()
        if self._coordinator:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.resume_every = max(1, int(resume_every))
        self._index_path = os.path.join(self.ckpt_dir, "index.json")
        self._index = self._load_index()
        self._executor = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
            if async_save and not self._multi
            else None
        )
        self._pending: list[Future] = []
        self.background_write_seconds = 0.0

    def _load_index(self) -> dict:
        if os.path.exists(self._index_path):
            with open(self._index_path, "r") as handle:
                return json.load(handle)
        return {"entries": [], "latest": None}

    def _settled_index(self) -> dict:
        """The index every process agrees on: re-read from the shared
        directory under more than one process (only rank 0 keeps
        ``self._index`` up to date; the other ranks read after the barrier
        that follows its write); the in-memory index otherwise."""
        if self._multi:
            self._index = self._load_index()
        return self._index

    def _write_index(self) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as handle:
            json.dump(self._index, handle, indent=2)
        os.replace(tmp, self._index_path)

    def _entry_name(self, epoch: int, metric: float) -> str:
        # Filename pattern mirrors the reference's ModelCheckpoint template.
        return f"model-epoch={epoch:02d}-{self.monitor}={metric:.4f}"

    def _save_kind(self, epoch: int, metric: float, force: bool) -> str | None:
        """``"full"``, ``"slim"``, or ``None`` (skip) for this epoch.

        Lightning's ModelCheckpoint (the reference contract) writes only
        when a metric enters the top-k; the JAX package adds a full resume
        point every ``resume_every`` epochs and at the forced final epoch.
        Top-k entries that are not resume points save slim. The top-k floor
        is taken over the k best metrics only: the retained latest entry's
        metric is usually low and would let nearly every epoch in.
        """
        is_resume_point = force or epoch % self.resume_every == 0
        top = sorted((e["metric"] for e in self._settled_index()["entries"]), reverse=True)[
            : self.save_top_k
        ]
        enters_topk = len(top) < self.save_top_k or metric > top[-1]
        if is_resume_point:
            return "full"
        if enters_topk:
            return "slim"
        return None

    def save(self, state: TrainState, epoch: int, metrics: dict,
             force: bool = False) -> str | None:
        """Save a checkpoint; retain top-k by monitored metric + the latest.

        Returns the entry's path, or None when the epoch is skipped
        (``_save_kind``; ``force=True``, the fit's final epoch, always
        writes, so a completed run has a latest for the no-op re-run).
        Async mode returns once the write is queued; the path exists when
        the worker has written it. A rank other than the coordinator
        returns None at once: it neither reads nor writes the index here.
        """
        if not self._coordinator:
            return None
        metric = float(lookup_metric(metrics, self.monitor, 0.0))
        name = self._entry_name(epoch, metric)
        path = os.path.join(self.ckpt_dir, name)
        if self._executor is not None:
            self.wait_until_finished()  # the index is settled from here on
        kind = self._save_kind(epoch, metric, force)
        if kind is None:
            return None
        payload = _payload(state, kind)
        args = (path, epoch, metrics, metric, name, kind)
        if self._executor is None:
            self._write(payload, None, *args)
            return path
        payload = _clone(payload)
        ready = None
        if _any_cuda(payload):
            ready = torch.cuda.Event()
            ready.record()
        self._pending.append(self._executor.submit(self._write, payload, ready, *args))
        return path

    def wait_until_finished(self) -> None:
        """Block until every queued save has been written; re-raise errors."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def _write(self, payload: dict, ready, path: str, epoch: int, metrics: dict,
               metric: float, name: str, kind: str) -> None:
        # On the writer thread: a root span of its own.
        with trace.span("checkpoint.write") as write:
            if ready is not None:
                ready.synchronize()
            # Written beside the entry and renamed into place: a torn write is
            # never seen as a checkpoint.
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(_to_host(payload), os.path.join(tmp, CHECKPOINT_FILE))
            if kind == "slim":
                with open(os.path.join(tmp, SLIM_MARKER), "w") as handle:
                    json.dump({"layout": sorted(k for k, v in payload.items()
                                                if v is not None)}, handle)
            with open(os.path.join(tmp, "metrics.json"), "w") as handle:
                json.dump({k: _scalar(v) for k, v in metrics.items()} | {"epoch": epoch},
                          handle, indent=2)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)

            entries = [e for e in self._index["entries"] if e["name"] != name]
            entries.append({"name": name, "metric": metric, "epoch": epoch, "kind": kind})
            entries.sort(key=lambda e: e["metric"], reverse=True)
            keep = entries[: self.save_top_k]
            # Resume restores a FULL state (slim entries carry no optimizer
            # state), so `latest` tracks the newest full entry.
            full = [e for e in entries if e.get("kind", "full") == "full"]
            latest = max(full, key=lambda e: e["epoch"]) if full else None
            keep_names = {e["name"] for e in keep}
            if latest is not None:
                keep_names.add(latest["name"])
            for entry in entries[self.save_top_k:]:
                if entry["name"] not in keep_names:
                    shutil.rmtree(os.path.join(self.ckpt_dir, entry["name"]),
                                  ignore_errors=True)
            self._index["entries"] = [e for e in entries if e["name"] in keep_names]
            self._index["latest"] = latest["name"] if latest else None
            self._write_index()
        self.background_write_seconds += write.seconds

    @property
    def best_model_path(self) -> str | None:
        self.wait_until_finished()
        index = self._settled_index()
        if not index["entries"]:
            return None
        best = max(index["entries"], key=lambda e: e["metric"])
        return os.path.join(self.ckpt_dir, best["name"])

    @property
    def latest_model_path(self) -> str | None:
        self.wait_until_finished()
        index = self._settled_index()
        if index["latest"] is None:
            return None
        return os.path.join(self.ckpt_dir, index["latest"])

    @property
    def latest_epoch(self) -> int | None:
        self.wait_until_finished()
        index = self._settled_index()
        if index["latest"] is None:
            return None
        for entry in index["entries"]:
            if entry["name"] == index["latest"]:
                return entry["epoch"]
        return None

    def restore(self, path: str, state: TrainState) -> TrainState:
        """``load_checkpoint`` after draining pending writes."""
        self.wait_until_finished()
        return load_checkpoint(path, state)


def _payload(state: TrainState, kind: str) -> dict:
    """What a checkpoint stores, as references to the live tensors."""
    out = {"model": state.model.state_dict(), "step": int(state.step),
           "ema_params": state.ema_params}
    if kind == "full":
        out["optimizer"] = state.optimizer.state_dict()
    return out


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _clone(payload: dict) -> dict:
    """Fresh copies of every tensor, on the tensors' devices."""
    return _map_tensors(payload, lambda t: t.detach().clone())


def _to_host(payload: dict) -> dict:
    return _map_tensors(payload, lambda t: t.detach().cpu())


def _any_cuda(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, dict):
        obj = list(obj.values())
    return isinstance(obj, (list, tuple)) and any(_any_cuda(v) for v in obj)


def _scalar(value):
    if isinstance(value, (int, float, str)):
        return value
    return float(value)


def read_checkpoint(path: str) -> dict:
    """The payload of a checkpoint directory, tensors on the CPU."""
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)


def eval_state_dict(payload: dict) -> dict:
    """The state dict evaluation loads from a checkpoint payload: the
    model's, with its ``ema_params`` in place of the parameters when it has
    them (the weights validation selected an EMA-trained run by)."""
    state = dict(payload["model"])
    state.update(payload.get("ema_params") or {})
    return state


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a checkpoint directory into ``state`` in place (the analog of
    load_from_checkpoint, predict.py:174-177) and return it.

    The model's parameters and statistics, ``step`` and the EMA come from
    the checkpoint; a full one also restores the optimizer, a slim one
    leaves it as it is. The checkpoint's layout is the truth about what the
    run trained with: a checkpoint with ``ema_params`` needs a state built
    with EMA (else ValueError), and a state with EMA restored from a
    checkpoint without one drops it.
    """
    payload = read_checkpoint(path)
    ema = payload.get("ema_params")
    if ema is not None and state.ema_params is None:
        raise ValueError(
            f"checkpoint {path} stores ema_params the restore template lacks; "
            "build the state with the experiment's training config (ema_decay)"
        )
    state.model.load_state_dict(payload["model"], strict=True)
    if "optimizer" in payload:
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if ema is None:
        state.ema_params = None
    else:
        with torch.no_grad():
            for key, value in ema.items():
                state.ema_params[key].copy_(value)
    return state
