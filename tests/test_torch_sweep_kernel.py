"""The sweep's horizon-scan kernel (``wva_tpu_torch/sweep/csrc/world_scan.cu``)
against its plain version, and its wrapper on the CPU.

On the CPU (here): ``run_chunk`` on CPU tensors is the plain version and
launches nothing; ``scan_kernel.launch`` refuses CPU tensors and a pipeline
deeper than its maximum; the bound's bytes and chain terms at the bench
chunk; the float32 constants the wrapper passes are the values the plain
loop's PyTorch ops round its Python scalars to, in the source's order; the
plain version equals the reference's jitted ``run_worlds`` bit for bit on
the smoke grid.

On the card, the ``cuda``-marked tests (which skip without one) hold the
kernel to ``run_chunk_plain`` on the same CUDA tensors bit for bit, NaN as
NaN, over widths, model counts, pipeline depths (both sides of the
kernel's long-lead path at L = 2 tiles, and the deepest at 4,096 worlds),
fault tables, initial replicas, non-finite knob rows, horizons that end
inside a tile, chunks whose lanes end inside a block, and chunks of more
blocks than the card holds at once; chunks of 1 and 3 equal a chunk of
256 through the kernel, and each chunk is one
launch. On a machine with the card (where jax may be absent: the
reference is imported inside the one test that needs it):

    python -m pytest --noconftest tests/test_torch_sweep_kernel.py -m cuda -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wva_tpu_torch.emulator import loadgen
from wva_tpu_torch.sweep import knobs as kb
from wva_tpu_torch.sweep import scan_kernel
from wva_tpu_torch.sweep import world
from wva_tpu_torch.sweep.fidelity import DEFAULT_SCENARIO

SOURCE = (Path(__file__).resolve().parents[1] / "wva_tpu_torch" / "sweep"
          / "csrc" / "world_scan.cu")
PARAMS = world.WorldParams(horizon_s=1200.0)
TILE = int(re.search(r"kTile = (\d+);", SOURCE.read_text()).group(1))
LANES = int(re.search(r"kLanes = (\d+);", SOURCE.read_text()).group(1))
KEYS = ("attainment", "chip_seconds", "wrong_direction", "arrivals_total")
NON_FINITE = (kb.PolicyKnobs(target_utilization=float("nan")),
              kb.PolicyKnobs(level_gain=float("nan"),
                             grid_step_s=float("nan")),
              kb.PolicyKnobs(engine_interval_s=float("inf")),
              kb.PolicyKnobs(burst_slope_rps=float("inf"),
                             grid_step_s=float("-inf")))


def chunk(params, n_worlds, n_models, *, non_finite=False, seed=0):
    """Host inputs of a chunk: ``n_models`` trapezoids of different heights,
    the default grid's points cycled over ``n_worlds`` worlds (the first
    rows replaced by ``NON_FINITE`` when asked), seeded tables."""
    profiles = [loadgen.trapezoid(4.0 + 3.0 * i, 40.0 - 6.0 * i, 300.0,
                                  420.0, 180.0, tail=120.0, delay=180.0)
                for i in range(n_models)]
    lam = world.rate_table(profiles, params)
    points = kb.grid_points("default")
    knobs = [points[(seed + i) % len(points)] for i in range(n_worlds)]
    if non_finite:
        knobs[:len(NON_FINITE)] = NON_FINITE[:n_worlds]
    seeds = [1000 * seed + i for i in range(n_worlds)]
    rows = np.asarray([kb.to_vector(k) for k in knobs], dtype=np.float32)
    return (knobs, seeds, lam, rows, world.arrivals_table(seeds, lam, params),
            world.fault_table(seeds, n_models, params))


def assert_same(got, want):
    """Equal values, NaN where the other is NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), np.argwhere(
        np.isnan(got) != nan)[:8]
    differ = (got != want) & ~nan
    assert not differ.any(), (int(differ.sum()), np.argwhere(differ)[:8])


# ---------------------------------------------------------------- CPU


def test_run_chunk_on_cpu_tensors_is_the_plain_version():
    _, _, lam, rows, arr, flt = chunk(PARAMS, 12, 2, non_finite=True)
    before = scan_kernel.launches
    inputs = world.chunk_tensors(rows, lam, arr, flt, "cpu")
    got = world.run_chunk(PARAMS, *inputs, 1.0)
    want = world.run_chunk_plain(PARAMS, *inputs, 1.0)
    assert scan_kernel.launches == before
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.shape == (12, 2)
        assert_same(g.numpy(), w.numpy())


def test_launch_refuses_cpu_tensors_and_a_deep_pipeline():
    _, _, lam, rows, arr, flt = chunk(PARAMS, 3, 1)
    inputs = world.chunk_tensors(rows, lam, arr, flt, "cpu")
    consts = world.scan_constants(PARAMS, 1.0)
    before = scan_kernel.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        scan_kernel.launch(*inputs, consts, lead=PARAMS.lead_steps)
    for lead in (0, scan_kernel.MAX_LEAD + 1):
        with pytest.raises(ValueError, match="outside the kernel's"):
            scan_kernel.launch(*inputs, consts, lead=lead)
    assert scan_kernel.launches == before


def test_bound_at_the_bench_chunk():
    w = scan_kernel.work(256, 1, 240)
    assert len(kb.KNOB_FIELDS) == 13
    # knob rows, rates, arrival and fault tables, four outputs; float32.
    assert w.bytes == 4 * (256 * 13 + 240 + 2 * 240 * 256 + 4 * 256) == 509888
    assert w.chain_ops == 240 * scan_kernel.CHAIN_OPS_PER_STEP == 1920
    terms = w.bound_terms_ms()
    assert terms["bytes"] == pytest.approx(509888 / 3.35e12 * 1e3)
    assert terms["chain"] == pytest.approx(1920 * 4 / 1.98e9 * 1e3)
    assert w.bound() == (terms["chain"], "chain")
    assert scan_kernel.work(0, 1, 240).chain_ops == 0


def test_source_layout_matches_the_wrapper():
    """The kernel's ``Consts`` fields, knob columns and limits, read from
    the source, are the wrapper's."""
    src = SOURCE.read_text()
    body = re.search(r"struct Consts \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*float ([\w, ]+);", body, re.M)
    names = tuple(n.strip() for line in fields for n in line.split(","))
    assert names == scan_kernel.CONSTANT_NAMES
    # Each knob column's name: the leading words of its KNOB_FIELDS name,
    # at its index.
    enum = re.search(r"enum Knob \{(.*?)\};", src, re.S).group(1)
    listed = re.findall(r"k(\w+) = (\d+),", enum)
    assert [int(i) for _, i in listed] == list(range(len(kb.KNOB_FIELDS)))
    for (name, _), field in zip(listed, kb.KNOB_FIELDS, strict=True):
        words = re.findall(r"[A-Z][a-z]*", name)
        assert [w.lower() for w in words] == field.split("_")[:len(words)], \
            (name, field)
    assert int(re.search(r"kMaxLead = (\d+);", src).group(1)) \
        == scan_kernel.MAX_LEAD
    assert int(re.search(r"kKnobs = (\d+);", src).group(1)) \
        == len(kb.KNOB_FIELDS)
    assert "-fmad=false" in scan_kernel.LIBRARY.flags


@pytest.mark.parametrize("params", [
    PARAMS,
    world.WorldParams(horizon_s=600.0, startup_s=5.0, dt=2.5,
                      max_batch=64, avg_input_tokens=1000.0,
                      slo_ttft_s=0.7, down_stabilization_s=33.0),
], ids=["bench", "other"])
def test_constants_are_the_plain_loops(params):
    """Each constant, rounded to float32, is the value PyTorch gives the
    plain loop's Python scalar, and the kernel's expressions over them
    repeat the plain loop's ops bit for bit."""
    consts = world.scan_constants(params, 4.0)
    assert tuple(consts) == scan_kernel.CONSTANT_NAMES
    f = {k: np.float32(v) for k, v in consts.items()}
    n = np.random.default_rng(7).uniform(0.0, 200.0, 4096).astype(np.float32)
    nt = torch.from_numpy(n)
    # iteration_ms: alpha + n * slope; prefill: that + (beta+gamma)*in.
    np.testing.assert_array_equal(world.iteration_ms(params, nt).numpy(),
                                  n * f["iter_slope"] + f["alpha"])
    np.testing.assert_array_equal(
        world.prefill_ms(params, nt).numpy(),
        (n * f["iter_slope"] + f["alpha"]) + f["prefill_extra"])
    np.testing.assert_array_equal(
        (params.avg_output_tokens * world.iteration_ms(params, nt)).numpy(),
        (n * f["iter_slope"] + f["alpha"]) * f["out_tokens"])
    # Python scalars the step multiplies, adds and compares by.
    for name, expr in (
            ("rate_full", lambda x: x * world.replica_rps(
                params, float(params.max_batch))),
            ("dt", lambda x: x * params.dt),
            ("max_batch", lambda x: x * params.max_batch),
            ("queue_bound", lambda x: params.queue_bound * x),
            ("startup", lambda x: x * params.startup_s),
            ("err_gain", lambda x: 0.2 * x),
            ("eps", lambda x: x + world._EPS),
            ("ms", lambda x: 1000.0 * x)):
        got = expr(nt).numpy()
        want = (n + f[name] if name == "eps" else n * f[name])
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(
        (nt * params.chips_per_replica * params.dt).numpy(),
        n * f["chips_per_replica"] * f["dt"])
    # The SLO comparison is in float32 too (0.3 and 0.7 round up and down).
    for slo in (params.slo_ttft_s, 0.3, 0.7):
        x = np.float32(slo)
        near = np.array([np.nextafter(x, np.float32(0)), x,
                         np.nextafter(x, np.float32(1))], dtype=np.float32)
        np.testing.assert_array_equal((torch.from_numpy(near) <= slo).numpy(),
                                      near <= x)
    assert f["slo_ttft"] == np.float32(params.slo_ttft_s)
    assert f["steps"] == params.steps and f["lead"] == params.lead_steps
    assert f["stab_steps"] == max(
        int(round(params.down_stabilization_s / params.dt)), 1)
    assert f["init_replicas"] == 4.0 and f["two"] == 2.0
    assert f["max_replicas"] == params.max_replicas


def test_plain_equals_the_reference_bitwise_on_the_smoke_grid():
    from wva_tpu.emulator import loadgen as ref_loadgen
    from wva_tpu.sweep import knobs as ref_kb
    from wva_tpu.sweep import world as ref_world

    ref_params = ref_world.WorldParams(horizon_s=1200.0)
    lam = world.rate_table([loadgen.trapezoid(
        4.0, 40.0, 300.0, 420.0, 180.0, tail=120.0, delay=180.0)], PARAMS)
    np.testing.assert_array_equal(lam, ref_world.rate_table([
        ref_loadgen.trapezoid(4.0, 40.0, 300.0, 420.0, 180.0, tail=120.0,
                              delay=180.0)], ref_params))
    points = kb.grid_points("smoke")
    seeds = list(range(100, 100 + len(points)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mine = world.run_worlds(PARAMS, points, seeds, lam, device="cpu")
    finally:
        torch.set_num_threads(threads)
    ref = ref_world.run_worlds(ref_params, ref_kb.grid_points("smoke"),
                               seeds, lam)
    for key in KEYS + ("objective", "score"):
        assert mine[key].dtype == ref[key].dtype, key
        assert np.array_equal(mine[key], ref[key]), key


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def kernel_and_plain(params, n_worlds, n_models, device, init=1.0,
                     non_finite=False, seed=0):
    """The kernel's and the plain version's ``[4, W, M]`` outputs on the
    same CUDA tensors, and the launches the kernel's call made."""
    *_, lam, rows, arr, flt = chunk(params, n_worlds, n_models,
                                    non_finite=non_finite, seed=seed)
    inputs = world.chunk_tensors(rows, lam, arr, flt, device)
    before = scan_kernel.launches
    got = torch.stack(world.run_chunk(params, *inputs, init))
    launched = scan_kernel.launches - before
    want = torch.stack(world.run_chunk_plain(params, *inputs, init))
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy(), launched


@pytest.mark.cuda
@pytest.mark.parametrize("n_models", [1, 3])
@pytest.mark.parametrize("n_worlds", [1, 3, 256, 1000])
def test_kernel_matches_plain(cuda, n_worlds, n_models):
    got, want, launched = kernel_and_plain(PARAMS, n_worlds, n_models, cuda,
                                           seed=n_worlds + n_models)
    assert launched == 1
    assert np.isfinite(want).all()
    assert_same(got, want)


FIDELITY_LEAD = world.WorldParams(
    startup_s=DEFAULT_SCENARIO["startup_s"]).lead_steps


@pytest.mark.cuda
@pytest.mark.parametrize("startup_s", [
    5.0, 120.0, DEFAULT_SCENARIO["startup_s"], 300.0,
    5.0 * scan_kernel.MAX_LEAD], ids=["L=1", "L=24", f"fidelity-L="
                                      f"{FIDELITY_LEAD}", "L=60",
                                      f"L={scan_kernel.MAX_LEAD}"])
def test_kernel_matches_plain_at_every_lead(cuda, startup_s):
    params = world.WorldParams(horizon_s=1200.0, startup_s=startup_s)
    got, want, _ = kernel_and_plain(params, 256, 1, cuda, seed=3)
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [2 * TILE - 1, 2 * TILE])
def test_kernel_matches_plain_at_the_long_lead_edge(cuda, lead):
    """Leads below two tiles mask each step's window and read the matured
    lane each step; from two tiles on neither is needed."""
    params = world.WorldParams(horizon_s=1200.0, startup_s=5.0 * lead)
    assert params.lead_steps == lead
    got, want, _ = kernel_and_plain(params, 256, 1, cuda, seed=lead)
    assert_same(got, want)


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_deepest_lead_at_4096_worlds(cuda):
    params = world.WorldParams(horizon_s=1200.0,
                               startup_s=5.0 * scan_kernel.MAX_LEAD)
    got, want, launched = kernel_and_plain(params, 4096, 1, cuda, seed=9)
    assert launched == 1
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n_models", [(24, 1), (1, 3), (128, 1)])
def test_kernel_matches_plain_past_one_wave(cuda, lead, n_models):
    """A block an SM: 6,000 worlds take more blocks than the card holds at
    once, 256 worlds fewer; both with non-finite knob rows."""
    params = world.WorldParams(horizon_s=1200.0, startup_s=5.0 * lead)
    for n_worlds in (256, 6000):
        got, want, launched = kernel_and_plain(
            params, n_worlds, n_models, cuda, non_finite=True, seed=lead)
        assert launched == 1
        assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_models", [1, 3])
@pytest.mark.parametrize("steps", [1, TILE - 1, TILE + 1])
def test_kernel_matches_plain_on_ragged_tiles(cuda, steps, n_models):
    """Horizons that end inside a tile of the kernel's steps."""
    params = world.WorldParams(horizon_s=5.0 * steps, startup_s=60.0)
    assert params.steps == steps
    got, want, launched = kernel_and_plain(params, 64, n_models, cuda,
                                           seed=steps)
    assert launched == 1
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_worlds,n_models", [(LANES + 5, 1), (13, 3)])
def test_kernel_matches_plain_on_ragged_lane_groups(cuda, n_worlds,
                                                    n_models):
    """W x M not a multiple of a block's lanes: the last block's spare
    threads write nothing."""
    assert n_worlds * n_models % LANES
    got, want, _ = kernel_and_plain(PARAMS, n_worlds, n_models, cuda,
                                    seed=n_worlds)
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("init", [1.0, 4.0])
@pytest.mark.parametrize("fault_gap_s", [0.0, 600.0],
                         ids=["faults-off", "faults-on"])
def test_kernel_matches_plain_with_faults_and_initial_replicas(
        cuda, fault_gap_s, init):
    params = world.WorldParams(horizon_s=1200.0,
                               fault_mean_gap_s=fault_gap_s)
    got, want, _ = kernel_and_plain(params, 256, 2, cuda, init=init, seed=5)
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_models", [1, 3])
def test_kernel_matches_plain_on_non_finite_knobs(cuda, n_models):
    got, want, _ = kernel_and_plain(PARAMS, 64, n_models, cuda,
                                    non_finite=True, seed=11)
    assert np.isnan(want[:, :2]).any(), "no NaN world in the chunk"
    assert_same(got, want)


@pytest.mark.cuda
def test_lead_above_the_maximum_is_refused_on_the_card(cuda):
    params = world.WorldParams(horizon_s=1200.0,
                               startup_s=5.0 * (scan_kernel.MAX_LEAD + 1))
    *_, lam, rows, arr, flt = chunk(params, 4, 1)
    inputs = world.chunk_tensors(rows, lam, arr, flt, cuda)
    before = scan_kernel.launches
    with pytest.raises(ValueError, match="outside the kernel's"):
        world.run_chunk(params, *inputs, 1.0)
    assert scan_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3])
def test_chunk_width_is_bitwise_invisible_through_the_kernel(cuda, width):
    knobs, seeds, lam, _, arr, flt = chunk(PARAMS, 24, 1, non_finite=True,
                                           seed=2)
    wide = world.run_worlds(PARAMS, knobs, seeds, lam, chunk=256,
                            arrivals=arr, faults=flt, device=cuda)
    before = scan_kernel.launches
    narrow = world.run_worlds(PARAMS, knobs, seeds, lam, chunk=width,
                              arrivals=arr, faults=flt, device=cuda)
    assert scan_kernel.launches - before == -(-24 // width)
    for key in KEYS + ("objective", "score"):
        assert_same(narrow[key], wide[key])


@pytest.mark.cuda
def test_one_launch_per_chunk(cuda):
    knobs, seeds, lam, _, arr, flt = chunk(PARAMS, 600, 1, seed=4)
    before = scan_kernel.launches
    res = world.run_worlds(PARAMS, knobs, seeds, lam, chunk=256,
                           arrivals=arr, faults=flt, device=cuda)
    assert scan_kernel.launches - before == 3
    assert res["attainment"].shape == (600, 1)
