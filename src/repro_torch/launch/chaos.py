"""Kill-and-resume chaos harness for the training checkpoint path.

Port of ``repro.launch.chaos``. The claim under test is the strongest
form of crash safety the trainers promise: a run that is SIGKILLed
mid-chunk (no cleanup, no atexit; the atomic checkpoint writes leave
nothing torn) and then relaunched into the same checkpoint directory
finishes with metric trajectories BIT-IDENTICAL to a run that was never
interrupted. The harness:

1. launches ``python -m repro_torch.launch.chaos --child ...``, a
   subprocess running a checkpointed ``train_sac`` that prints
   ``METRICS {json}`` (and its kernel launches, ``KERNELS {json}``) when
   it completes;
2. polls the checkpoint directory until a resumable step lands
   (``latest_checkpoint_step``), then delivers ``SIGKILL``: the child
   dies between chunk boundaries, where a real preemption would land;
3. relaunches the same command; the child restores the checkpoint and
   trains the remaining episodes;
4. compares the resumed metrics with an uninterrupted in-process run,
   element for element (floats by equality, not tolerance).

``--seeds`` runs the whole dance once per seed. ``--device`` (``cuda``
by default; ``cpu`` on a machine without a card) is where every run
trains. Exit code 0 = every seed bit-identical. Run from the repository
root::

    PYTHONPATH=src python -m repro_torch.launch.chaos --device cpu --seeds 0,1
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

SRC = Path(__file__).resolve().parents[2]


def _train(args, checkpoint_dir: Optional[str]):
    from repro_torch.core.agents.loops import train_sac
    from repro_torch.core.agents.sac import SACConfig
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile

    env = MHSLEnv(profile=resnet101_profile(batch=1), device=args.device)
    kw = {}
    if checkpoint_dir is not None:
        kw = dict(checkpoint_dir=checkpoint_dir,
                  checkpoint_every=args.checkpoint_every)
    res = train_sac(env, SACConfig(), episodes=args.episodes, seed=args.seed,
                    warmup_episodes=args.warmup, num_envs=args.num_envs, **kw)
    return {
        "episode_reward": res.episode_reward,
        "episode_leak": res.episode_leak,
        "episode_violation": res.episode_violation,
        "states_explored": res.states_explored,
    }


def _launches() -> dict:
    from repro_torch.launch.train_mhsl_rl import kernel_launches

    return kernel_launches()


def _child_main(args) -> None:
    """Subprocess body: one checkpointed ``train_sac`` run, metrics to
    stdout."""
    metrics = _train(args, args.dir)
    print("METRICS " + json.dumps(metrics), flush=True)
    print("KERNELS " + json.dumps(_launches()), flush=True)


def _child_cmd(args, ckpt_dir: str) -> List[str]:
    return [
        sys.executable, "-m", "repro_torch.launch.chaos", "--child",
        "--dir", ckpt_dir, "--seed", str(args.seed),
        "--episodes", str(args.episodes), "--warmup", str(args.warmup),
        "--num-envs", str(args.num_envs),
        "--checkpoint-every", str(args.checkpoint_every),
        "--device", args.device,
    ]


def _child_env() -> dict:
    """The child's environment: this one, with the port's ``src`` first
    on ``PYTHONPATH`` wherever the harness was started from."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _parse(stdout: str, tag: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise RuntimeError(f"no {tag} line in child output:\n{stdout}")


def _launch(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=_child_env())


def kill_and_resume(args, ckpt_dir: str) -> dict:
    """One chaos round: launch, SIGKILL after the first resumable
    checkpoint, relaunch to completion. Returns ``{"metrics", "kernels",
    "killed"}`` of the resumed run."""
    from repro_torch.checkpoint.train_state import latest_checkpoint_step

    cmd = _child_cmd(args, ckpt_dir)
    victim = _launch(cmd)
    deadline = time.monotonic() + args.timeout
    killed = False
    try:
        while time.monotonic() < deadline:
            step = latest_checkpoint_step(ckpt_dir)
            if step is not None and step >= args.kill_after:
                if victim.poll() is None:
                    victim.send_signal(signal.SIGKILL)
                    killed = True
                break
            if victim.poll() is not None:
                break  # finished before the kill: the resume still runs
            time.sleep(0.05)
        else:
            victim.kill()
            out = victim.communicate()[0]
            raise TimeoutError(
                f"no checkpoint >= {args.kill_after} within {args.timeout}s; "
                f"child output:\n{out}")
        out = victim.communicate()[0]
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.communicate()
    if not killed:
        if victim.returncode != 0:
            raise RuntimeError(f"child exited {victim.returncode} before the "
                               f"kill:\n{out}")
        print("  [warn] child finished before the kill landed (checkpoint "
              "cadence too coarse?); resume still exercised", flush=True)
    survivor = _launch(cmd)
    try:
        out, _ = survivor.communicate(timeout=args.timeout)
    finally:
        if survivor.poll() is None:
            survivor.kill()
            survivor.communicate()
    if survivor.returncode != 0:
        raise RuntimeError(f"resume run exited {survivor.returncode}:\n{out}")
    return {"metrics": _parse(out, "METRICS"), "kernels": _parse(out, "KERNELS"),
            "killed": killed}


def reference_metrics(args) -> dict:
    """The uninterrupted run, in-process (same code path, no faults)."""
    return _train(args, None)


def compare(resumed: dict, reference: dict) -> List[str]:
    """Bit-exact comparison; returns human-readable mismatches."""
    problems = []
    for k in sorted(set(resumed) | set(reference)):
        a, b = resumed.get(k), reference.get(k)
        if a != b:
            problems.append(f"{k}: resumed {a} != reference {b}")
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help="internal: run the training child process")
    ap.add_argument("--dir", default=None,
                    help="checkpoint directory (child) / scratch root")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seed matrix (overrides --seed)")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--num-envs", type=int, default=2)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--kill-after", type=int, default=2,
                    help="SIGKILL once a checkpoint at >= this episode exists")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="where every run trains (cuda unless given)")
    args = ap.parse_args(argv)

    if args.child:
        if args.dir is None:
            ap.error("--child requires --dir")
        _child_main(args)
        return 0

    from repro_torch.device import resolve_device

    resolve_device(args.device)  # no card: refuse here, not in a child
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [args.seed])
    failures = 0
    for seed in seeds:
        args.seed = seed
        with tempfile.TemporaryDirectory(dir=args.dir) as root:
            ckpt_dir = os.path.join(root, f"chaos_seed{seed}")
            print(f"[chaos] seed {seed}: kill-and-resume on {args.device} ...",
                  flush=True)
            t0 = time.perf_counter()
            resumed = kill_and_resume(args, ckpt_dir)
            print(f"[chaos] seed {seed}: kill landed before the child finished: "
                  f"{resumed['killed']}; both children {time.perf_counter() - t0:.2f} s; "
                  f"resumed child's kernel launches {json.dumps(resumed['kernels'])}",
                  flush=True)
            print(f"[chaos] seed {seed}: uninterrupted reference ...", flush=True)
            before = _launches()
            ref = reference_metrics(args)
            ran = {k: v - before[k] for k, v in _launches().items()}
            print(f"[chaos] seed {seed}: reference kernel launches {json.dumps(ran)}",
                  flush=True)
            problems = compare(resumed["metrics"], ref)
            if problems:
                failures += 1
                print(f"[chaos] seed {seed}: MISMATCH", flush=True)
                for p in problems:
                    print("  " + p, flush=True)
            else:
                n = len(ref["episode_reward"])
                print(f"[chaos] seed {seed}: OK - {n} episode metrics "
                      f"bit-identical after SIGKILL + resume", flush=True)
    if failures:
        print(f"[chaos] {failures}/{len(seeds)} seeds FAILED", flush=True)
        return 1
    print(f"[chaos] all {len(seeds)} seed(s) bit-identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
