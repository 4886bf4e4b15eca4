"""The comparison that decides ``correct``, on the CPU at tiny widths: a
cell's configuration at its family's tiny widths (``_cell``; for the
decoder LMs the port's ``ModelConfig.reduced()`` widths: 2 layers, d 256,
4 query and 2 KV heads of 64, FFN 512, vocabulary 512, 4 experts of width
128, top-2), 4 rows of 32 tokens in 2 microbatches, two stages; its
family, optimizer, init rules and limits are the cell's own.

* The port's step in f32 agrees with the plain reference to round-off,
  and the port in bf16, a lower precision, fails that agreement.
* The benchmark's control (the reference in the program's place, its
  products in float8) lies farther from the reference than the port in
  the configuration's bf16 does. (Its readings at the cells' own sizes,
  which the limits come from, are taken on the card by
  ``perfbench/calibrate.py``; at these widths the limits do not apply.)
* A whole run of the cell, its program's step in f32 so that it is
  correct under the cell's limits, comes out not correct with the timed
  path broken underneath: a step that returns its state unchanged, half
  of the batch left out, and, where the cell compares the loss, the loss
  altered where it is made.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

from perfbench import compare, spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
F32_AGREEMENT = 1e-5  # the f32 port reads 1e-6 at most (tiny widths, seeds 1-2)


def _cell(name, compute="float32"):
    """The cell at its family's tiny widths (its ports file's
    ``tiny(conf)``), in two stages of which the first holds one layer."""
    c = copy.deepcopy(spec.cell(name))
    ports = spec.family("ports", c.config["family"])
    c.config.update(ports.tiny(c.config))
    c.config["plan"]["boundaries"] = [1, ports.model_config(c.config).num_layers]
    c.config["dtypes"]["compute"] = compute
    c.traffic.update(rows=4, seq=32, microbatches=2, trace_steps=1)
    return c


def _readings(cell, seed, precision=None):
    train = spec.runner("train")
    dev = torch.device("cpu")
    prog = train.Program(cell, seed, dev)
    ours, batches = prog.check_steps(int(cell.check["steps"]))
    micro = cell.traffic["microbatches"]
    ref = train.reference(cell, seed, prog.layout, batches, micro, "float32", dev)
    other = None
    if precision is not None:
        other = train.reference(cell, seed, prog.layout, batches, micro, precision, dev)
    return ours, ref, other


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_f32_port_agrees_with_the_reference(name):
    ours, ref, _ = _readings(_cell(name), 7)
    gaps = compare.gaps(ours, ref)
    assert all(v < F32_AGREEMENT for v in gaps.values()), gaps


@pytest.mark.parametrize("name", CELLS)
def test_bf16_port_fails_the_f32_agreement(name):
    ours, ref, _ = _readings(_cell(name, "bfloat16"), 7)
    gaps = compare.gaps(ours, ref)
    assert max(gaps.values()) > 10 * F32_AGREEMENT, gaps


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("name", CELLS)
def test_float8_control_reads_beyond_the_program(name, seed):
    cell = _cell(name, "bfloat16")
    ours, ref, ctl = _readings(cell, seed, cell.config["dtypes"]["control"])
    assert compare.gaps(ctl, ref)["grad_dist"] > 1.3 * compare.gaps(ours, ref)["grad_dist"]


def _state_unchanged(make):
    def factory(*a, **kw):
        step = make(*a, **kw)

        def broken(params, opt_state, toks, labs):
            _, _, loss, norm = step(params, opt_state, toks, labs)
            return params, opt_state, loss, norm
        return broken
    return factory


def _half_batch(make):
    def factory(cfg, boundaries, n_micro, pipe, opt, **kw):
        step = make(cfg, boundaries, n_micro // 2, pipe, opt, **kw)

        def broken(params, opt_state, toks, labs):
            half = toks.shape[0] // 2
            return step(params, opt_state, toks[:half], labs[:half])
        return broken
    return factory


def _loss_altered(make):
    def factory(*a, **kw):
        step = make(*a, **kw)

        def broken(params, opt_state, toks, labs):
            params, opt_state, loss, norm = step(params, opt_state, toks, labs)
            return params, opt_state, loss * 1.01, norm
        return broken
    return factory


def _run(name):
    res = spec.runner("train").run(_cell(name), 11, 0.05, False, "cpu", 0.0,
                                   log=lambda msg: None)
    return res


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "loss_altered": _loss_altered}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "loss_altered" or "loss_gap" in spec.cell(c).check["limits"]]


@pytest.mark.parametrize("name, fault", CASES)
def test_broken_step_is_not_correct(name, fault, monkeypatch):
    from repro_torch.launch import train_mhsl_rl as RUN

    monkeypatch.setattr(RUN, "make_pipeline_train_step",
                        FAULTS[fault](RUN.make_pipeline_train_step))
    res = _run(name)
    assert not res["correct"], res["checks"]
