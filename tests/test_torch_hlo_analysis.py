"""The port's collective records and roofline (``repro_torch.launch.
hlo_analysis``, fed by ``distribution.collectives.record_collectives``),
mirroring ``tests/test_hlo_analysis.py``: the reference's wire factors on
the records its HLO example holds (a 256 B all-gather over 2, a 64 B
all-reduce over 4), the per-tick normalization, and the roofline's pick
at the H100's rates. The transfers of a run of ranks are recorded in
``tests/test_torch_stage_mesh.py``'s rank group."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.launch import hlo_analysis as JH  # noqa: E402
from repro_torch.distribution import collectives as C  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from test_hlo_analysis import HLO  # noqa: E402


def _example():
    """The records of the reference's HLO example: an all-gather of an
    f32[8,8] result over groups of 2 in a 5-trip loop, and one all-reduce
    of f32[4,4] over 4."""
    st = H.CollectiveStats()
    for _ in range(5):
        st.add("all-gather", 8 * 8 * 4, 2)
    st.add("all-reduce", 4 * 4 * 4, 4)
    return st


def test_wire_factors_match_the_reference():
    st = H.CollectiveStats()
    st.add("all-gather", 256, 2)
    assert st.result_bytes["all-gather"] == 256
    assert st.wire_bytes["all-gather"] == 128.0
    st.add("all-reduce", 64, 4)
    assert st.wire_bytes["all-reduce"] == 96.0
    st.add("reduce-scatter", 64, 4)
    assert st.wire_bytes["reduce-scatter"] == 192.0
    st.add("all-to-all", 64, 4)
    assert st.wire_bytes["all-to-all"] == 48.0
    st.add("collective-permute", 64, 3)
    assert st.wire_bytes["collective-permute"] == 64.0
    st.add("broadcast", 64, 4)
    assert st.wire_bytes["broadcast"] == 48.0
    assert st.counts == dict.fromkeys(H.COLLECTIVES, 1)
    assert st.group_sizes["all-gather"] == {2: 1}
    assert st.total_wire_bytes == 128 + 96 + 192 + 48 + 64 + 48
    assert st.total_result_bytes == 256 + 5 * 64
    with pytest.raises(ValueError):
        st.add("gather", 64, 2)
    # the reference's parse of its example gives the same records
    ref = JH.parse_collectives(HLO, loop_aware=True)
    mine = _example()
    assert mine.counts == ref.counts
    assert mine.result_bytes == ref.result_bytes
    assert mine.wire_bytes == ref.wire_bytes


def test_pipeline_collective_counts():
    per_tick = H.pipeline_collective_counts(_example(), n_ticks=5)
    assert per_tick["all-gather"] == 1.0
    assert per_tick["all-reduce"] == 1 / 5
    assert per_tick == JH.pipeline_collective_counts(HLO, n_ticks=5)


def test_roofline_dominant_at_h100_rates():
    coll = H.CollectiveStats(result_bytes={"all-reduce": 10},
                             wire_bytes={"all-reduce": 1e9}, counts={})
    r = H.roofline_from({"flops": 1e12, "bytes accessed": 1e9}, coll, 5e11)
    assert r.dominant == "collective"
    assert r.compute_s == pytest.approx(1e12 / 989.4e12, rel=1e-12)
    assert r.memory_s == pytest.approx(1e9 / 3.35e12, rel=1e-12)
    assert r.collective_s == pytest.approx(1e9 / 450e9, rel=1e-12)
    assert r.useful_ratio == 0.5
    assert set(r.as_dict()) == set(JH.roofline_from({}, JH.CollectiveStats()).as_dict())
    # without a collective count, the pick is compute or memory
    r = H.roofline_from({"flops": 1e12, "bytes accessed": 1e10}, None)
    assert r.dominant == "memory" and r.collective_s == 0.0
    assert H.roofline_from({"flops": 1e15, "bytes accessed": 1e9}, None).dominant == "compute"


def test_one_rank_mesh_records_nothing():
    mesh = make_host_mesh(1, 1, device="cpu")
    x = torch.arange(16.0).reshape(4, 4)
    assert C._RECORDER is None
    with C.record_collectives() as st:
        y = C.all_gather(x, mesh, "model", dim=0)
        z = C.all_reduce(x, mesh, ("data", "model"))
        w = C.reduce_scatter(x, mesh, "data")
        v = C.all_to_all(x, mesh, "model")
        b = C.broadcast(x, mesh, "model")
        g = C.all_gather_ad(x.requires_grad_(), mesh, "model")
        g.sum().backward()
    assert st.counts == {} and st.total_wire_bytes == 0
    for t in (y, z, w, v, b):
        assert torch.equal(t, x)
    assert C._RECORDER is None  # off again, nothing kept


def test_recorders_nest():
    st = H.CollectiveStats()
    with C.record_collectives() as outer:
        C._record("all-reduce", 16, torch.float32, 4)
        with C.record_collectives() as inner:
            C._record("all-gather", 8, torch.bfloat16, 2)
        C._record("all-reduce", 16, torch.float32, 4)
    st.add("all-reduce", 64, 4)
    st.add("all-reduce", 64, 4)
    assert outer.counts == {"all-reduce": 2} and outer.wire_bytes == st.wire_bytes
    assert inner.result_bytes == {"all-gather": 16}
    assert C._RECORDER is None
