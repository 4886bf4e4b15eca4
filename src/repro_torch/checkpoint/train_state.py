"""Stop/resume checkpoints of the port's trainers, the counterpart of
``repro.checkpoint.train_state``.

A training checkpoint is a pair of files per step under one directory:

* ``step_{N:08d}.npz``: the device state (agent parameters, optimizer
  state, replay storage, the states of the run's ``torch.Generator``s),
  written by :func:`repro_torch.checkpoint.store.save_pytree`;
* ``step_{N:08d}.json``: the host state (the episode counter, the
  per-episode curves, the distinct-states set, the replay ring's
  pointers), everything the loop keeps in Python between chunks;

and a ``LATEST`` file naming the newest step, written last. The trainers
save at chunk boundaries, where these are the whole state of the run:
restoring them and re-entering the loop replays the same draws on the
same data, so a resumed run is bit-identical to an uninterrupted one.

Where the reference saves its PRNG keys, the port saves generator states
(:func:`generator_leaf` / :func:`restore_generator`): the CPU generator's
Mersenne Twister state, or a CUDA generator's Philox seed and offset, as
``get_state()`` gives them (a uint8 tensor).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.store import load_pytree, save_pytree
from repro_torch.tree import tree_leaves

_STEP_RE = re.compile(r"^step_(\d{8})\.npz$")


def generator_leaf(gen: torch.Generator) -> torch.Tensor:
    """``gen``'s state as an npz leaf: a uint8 tensor on the CPU."""
    return gen.get_state()


def restore_generator(gen: torch.Generator, leaf: torch.Tensor) -> torch.Generator:
    """Set ``gen`` (CPU or CUDA) to a state saved by :func:`generator_leaf`;
    returns ``gen``."""
    # a copy: set_state on a view (a row of stacked states) crashes
    gen.set_state(leaf.detach().to("cpu", torch.uint8).clone())
    return gen


def pytree_fingerprint(tree: Any) -> Optional[str]:
    """sha256 over the bytes of ``tree``'s leaves in tree order, used to
    fingerprint the scenario physics a run was trained under. ``None`` in,
    ``None`` out (no scenario override)."""
    if tree is None:
        return None
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(torch.as_tensor(leaf).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def validate_resume(host_state: Dict[str, Any], meta: Dict[str, Any],
                    episodes: int, directory: str) -> int:
    """The trainers' resume gate: the checkpoint's run fingerprint must
    equal the caller's, and its episode counter must not be past the
    requested run length. Returns the restored episode counter."""
    if host_state.get("meta") != meta:
        raise ValueError(
            f"checkpoint {directory} was written by a run with "
            f"{host_state.get('meta')}, cannot resume with {meta}")
    ep = int(host_state["ep"])
    if ep > episodes:
        raise ValueError(
            f"checkpoint {directory} is at episode {ep}, past the "
            f"requested episodes={episodes}")
    return ep


def _npz_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def _json_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.json")


def save_train_checkpoint(directory: str, step: int, device_state: Any,
                          host_state: Dict[str, Any]) -> str:
    """Write one checkpoint; returns the ``.npz`` path. ``LATEST`` is
    replaced last, so a crash mid-write never spoils the newest resumable
    step."""
    os.makedirs(directory, exist_ok=True)
    save_pytree(device_state, _npz_path(directory, step))
    tmp = _json_path(directory, step) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, **host_state}, f)
    os.replace(tmp, _json_path(directory, step))
    tmp = os.path.join(directory, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(directory, "LATEST"))
    return _npz_path(directory, step)


def _complete(directory: str, step: int) -> bool:
    """Both halves exist: a crash between the two writes leaves an orphan
    that must not be offered for resume."""
    return (os.path.exists(_npz_path(directory, step))
            and os.path.exists(_json_path(directory, step)))


def latest_checkpoint_step(directory: str) -> Optional[int]:
    """The newest complete step in ``directory`` (``None`` when there is
    none). ``LATEST`` is trusted when it names a complete step, else the
    step files are scanned."""
    if not os.path.isdir(directory):
        return None
    latest = os.path.join(directory, "LATEST")
    if os.path.exists(latest):
        try:
            with open(latest) as f:
                step = int(f.read().strip())
        except (ValueError, OSError):
            step = None  # unreadable LATEST: fall back to the scan
        if step is not None and _complete(directory, step):
            return step
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _STEP_RE.match(name)) and _complete(directory, int(m.group(1)))]
    return max(steps) if steps else None


def load_train_checkpoint(directory: str, like: Any, *,
                          step: Optional[int] = None
                          ) -> Tuple[int, Any, Dict[str, Any]]:
    """``(step, device_state, host_state)`` of the newest (or the given)
    step; ``like`` is the freshly built device state (structure, shapes,
    dtypes and devices to restore onto)."""
    if step is None:
        step = latest_checkpoint_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    device_state = load_pytree(_npz_path(directory, step), like)
    with open(_json_path(directory, step)) as f:
        host_state = json.load(f)
    return step, device_state, host_state

