"""The port's kill-and-resume chaos harness (``repro_torch.launch.chaos``)
on the CPU, with ``tests/test_chaos.py``'s arguments: a checkpointed
``train_sac`` child is SIGKILLed after its first resumable checkpoint,
relaunched into the same directory, and its metrics are compared with an
uninterrupted in-process run by float equality (no tolerance)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.launch import chaos  # noqa: E402

ARGS = ["--seed", "5", "--episodes", "8", "--warmup", "4", "--num-envs", "2",
        "--checkpoint-every", "2", "--kill-after", "2", "--timeout", "420"]


def test_sigkill_resume_metrics_bit_identical(tmp_path, capsys):
    rc = chaos.main(["--dir", str(tmp_path), "--device", "cpu"] + ARGS)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "8 episode metrics bit-identical after SIGKILL + resume" in out
    assert list(tmp_path.iterdir()) == []  # the scratch directory is gone


def test_compare_reports_every_mismatch():
    ref = {"episode_reward": [1.0, 2.0], "states_explored": [1, 2]}
    assert chaos.compare(dict(ref), ref) == []
    bad = chaos.compare({"episode_reward": [1.0, 2.0000001],
                         "states_explored": [1, 2]}, ref)
    assert len(bad) == 1 and bad[0].startswith("episode_reward")


def test_cuda_default_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos.main(["--dir", str(tmp_path)] + ARGS)
