"""The EKF jacobian kernel's arithmetic, run as host C++ on the CPU.

``wva_tpu_torch/analyzers/queueing/csrc/ekf_jacobian.cu`` keeps its dual
numbers, the per-state functions and each thread's part of every sum in
functions that compile as host C++ as well: the text between ``namespace {``
and ``// ---- the kernel``, with ``__device__`` and ``__forceinline__``
defined away. This file compiles that text with ``g++ -O2
-ffp-contract=off`` into a temporary directory and drives it the way the
kernel's block does: every thread's states, each warp's shuffle scan and
butterflies lane by lane, the warps' sums in warp order. It holds h and H
against the plain version (``observe_and_jacobian_plain``, ``jacfwd`` on
CPU tensors) at ``tests/test_torch_tuner.py``'s points and at the edge
points of ``chip_smoke.JACOBIAN_EDGES``, and at the edge points against
the JAX package's ``_observe_and_jacobian`` as well: every entry of h and H
at rtol 2e-3, and each entry of H within 2e-3 of the largest entry of its
row. Torch's forward rules at ties
(``maximum``, ``minimum``, ``clamp(min=)``) are held against
``torch.func.jvp``. Needs ``g++``, no card:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_jacobian_host.py -q
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import wva_tpu.analyzers.queueing.tuner as j_tuner
from test_torch_tuner import POINTS, RTOL_H, _env_vec
from wva_tpu_torch.analyzers.queueing import jacobian_kernel
from wva_tpu_torch.analyzers.queueing import queue_model as qm
from wva_tpu_torch.analyzers.queueing import tuner

NEG_INF = float(np.float32(qm._NEG_INF))  # the clamp's floor in float32
SOURCE = (Path(__file__).resolve().parents[1] / "wva_tpu_torch" / "analyzers"
          / "queueing" / "csrc" / "ekf_jacobian.cu")

HARNESS = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline

namespace {
@BODY@

// Lane l of every warp takes op(own, lane l ^ off's) at off = 16 .. 1, as
// the kernel's shfl_xor butterflies do.
template <class T, class Op>
void butterfly(T* v, Op op) {
  for (int w = 0; w < kWarps; ++w)
    for (int off = 16; off > 0; off >>= 1) {
      T prev[32];
      for (int l = 0; l < 32; ++l) prev[l] = v[32 * w + l];
      for (int l = 0; l < 32; ++l) v[32 * w + l] = op(prev[l], prev[l ^ off]);
    }
}

// The kernel's block, thread by thread between its barriers.
void run_block(const float* x, const float* env, float* out) {
  const Cand c = candidate(x, env);
  const Dual lam = arrival_rate(c, env[0]);
  const Dual log_lam = dlog(clamp_min(lam, 1e-30f));
  Dual p_block = constant(NAN);
  static Dual lp[kThreads][kPerThread];

  // The prefix sum: the threads' own, the warps' Hillis-Steele scans (every
  // lane reads the lane off below before any lane writes), the warps'
  // totals before each warp.
  Dual incl[kThreads];
  for (int t = 0; t < kThreads; ++t)
    incl[t] = thread_prefix(c, log_lam, t, lp[t]);
  for (int w = 0; w < kWarps; ++w)
    for (int off = 1; off < 32; off <<= 1) {
      Dual prev[32];
      for (int l = 0; l < 32; ++l) prev[l] = incl[32 * w + l];
      for (int l = off; l < 32; ++l)
        incl[32 * w + l] = add(prev[l - off], prev[l]);
    }
  for (int t = 0; t < kThreads; ++t) {
    const Dual excl = t % 32 == 0 ? zero() : incl[t - 1];
    Dual offset = zero();
    for (int w = 0; w < t / 32; ++w) offset = add(offset, incl[32 * w + 31]);
    finish_prefix(add(offset, excl), lp[t]);
  }

  // logsumexp.
  float m_of[kThreads];
  for (int t = 0; t < kThreads; ++t) m_of[t] = thread_max(t, lp[t]);
  butterfly(m_of, max_nan);
  float maxima[kWarps];
  for (int w = 0; w < kWarps; ++w) maxima[w] = m_of[32 * w];
  const float m = block_max(maxima);
  Dual ws[kThreads];
  for (int t = 0; t < kThreads; ++t) ws[t] = thread_weights(t, lp[t], m);
  butterfly(ws, [](Dual a, Dual b) { return add(a, b); });
  Dual sums = zero();
  for (int w = 0; w < kWarps; ++w) sums = add(sums, ws[32 * w]);
  const Dual logz = log_partition(sums, m);

  // The moments, p_block, and the derived values.
  Moments mo[kThreads];
  for (int t = 0; t < kThreads; ++t)
    mo[t] = thread_moments(c, t, lp[t], logz, &p_block);
  butterfly(mo, [](Moments a, Moments b) { return add(a, b); });
  Moments total = {zero(), zero()};
  for (int w = 0; w < kWarps; ++w) total = add(total, mo[32 * w]);
  observation(c, lam, total, p_block, out);
}
}  // namespace

extern "C" {

void host_jacobian(const float* x, const float* env, float* out) {
  run_block(x, env, out);
}

// One forward rule on duals x and y (value and three tangents each):
// 0 maximum, 1 minimum, 2 clamp(x, min=y's value).
void host_rule(int op, const float* x, const float* y, float* out) {
  const Dual a = {x[0], x[1], x[2], x[3]}, b = {y[0], y[1], y[2], y[3]};
  const Dual r = op == 0 ? maximum(a, b) : op == 1 ? minimum(a, b)
                                                   : clamp_min(a, b.v);
  out[0] = r.v;
  out[1] = r.a;
  out[2] = r.b;
  out[3] = r.g;
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The kernel's host-C++ part compiled with the harness and loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    text = SOURCE.read_text()
    body = text[text.index("namespace {") + len("namespace {"):
                text.index("// ---- the kernel")]
    tmp = tmp_path_factory.mktemp("jacobian_host")
    src, lib = tmp / "jacobian_host.cc", tmp / "jacobian_host.so"
    src.write_text(HARNESS.replace("@BODY@", body))
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    ptr = ctypes.c_void_p
    so.host_jacobian.argtypes = [ptr] * 3
    so.host_jacobian.restype = None
    so.host_rule.argtypes = [ctypes.c_int, ptr, ptr, ptr]
    so.host_rule.restype = None
    return so


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def host_out(so, x, env):
    """The harness's ``[2, 4]`` output."""
    x = np.asarray(x, np.float32)
    env = np.asarray(env, np.float32)
    out = np.full(jacobian_kernel.OUT_SHAPE, np.nan, np.float32)
    so.host_jacobian(as_ptr(x), as_ptr(env), as_ptr(out))
    return out


def plain_out(x, env):
    """The plain version's h and H on CPU tensors, as one ``[2, 4]``."""
    h, jac = tuner.observe_and_jacobian_plain(
        torch.tensor(x, dtype=torch.float32),
        torch.tensor(env, dtype=torch.float32))
    return torch.cat([h[:, None], jac], dim=1).numpy()


def reference_out(x, env):
    """The JAX package's ``_observe_and_jacobian`` on the same float32
    inputs, as one ``[2, 4]``."""
    h, jac = j_tuner._observe_and_jacobian(np.asarray(x, np.float32),
                                           np.asarray(env, np.float32))
    return np.concatenate([np.asarray(h)[:, None], np.asarray(jac)], axis=1)


def assert_rows_close(got, want):
    """Each entry of H within RTOL_H of its row's largest entry
    (tests/test_torch_tuner.py's rule), and every entry of h and H at rtol
    RTOL_H: the row's rule alone would not see an error in a column far
    smaller than the row's largest (dh/dalpha beside dh/dgamma)."""
    assert np.isfinite(want).all() and np.isfinite(got).all(), (got, want)
    scale = np.abs(want[:, 1:]).max(axis=1, keepdims=True)
    assert np.all(np.abs(got[:, 1:] - want[:, 1:]) <= RTOL_H * scale), (
        got, want)
    np.testing.assert_allclose(got, want, rtol=RTOL_H)


@pytest.mark.parametrize("x, draw", POINTS)
def test_host_matches_plain_at_the_tuner_points(host, x, draw):
    env = _env_vec(draw)
    assert_rows_close(host_out(host, x, env), plain_out(x, env))


@pytest.mark.parametrize("name", sorted(chip_smoke.JACOBIAN_EDGES))
def test_host_matches_plain_at_the_edges(host, name):
    env = chip_smoke.JACOBIAN_EDGES[name]
    assert_rows_close(host_out(host, chip_smoke.TUNER_X, env),
                      plain_out(chip_smoke.TUNER_X, env))


@pytest.mark.parametrize("name", sorted(chip_smoke.JACOBIAN_EDGES))
def test_host_matches_the_reference_at_the_edges(host, name):
    """The edges against the JAX package itself, not only through the plain
    version: its test holds the plain version to the reference only at the
    tuner points."""
    env = chip_smoke.JACOBIAN_EDGES[name]
    assert_rows_close(host_out(host, chip_smoke.TUNER_X, env),
                      reference_out(chip_smoke.TUNER_X, env))


def _chain(env):
    """The plain version's rate bounds, the clipped rate and the masked
    chain's prefix sums at TUNER_X and ``env``."""
    x = torch.tensor(chip_smoke.TUNER_X, dtype=torch.float32)
    e = torch.tensor(env, dtype=torch.float32)
    cand = qm.CandidateBatch(
        alpha=x[0:1], beta=x[1:2], gamma=x[2:3], avg_input_tokens=e[1:2],
        avg_output_tokens=e[2:3], max_batch=e[3:4].to(torch.int32),
        k=e[4:5].to(torch.int32))
    lo, hi = qm.rate_bounds_per_ms(cand)
    lam = torch.minimum(torch.maximum(e[0:1], lo), hi)
    prefix = torch.cumsum(torch.log(lam[:, None]) - qm._masked_log_mu(
        cand, qm.K_MAX), dim=1)[0]
    return float(lo), float(hi), float(e[0]), prefix


@pytest.mark.parametrize("name", sorted(chip_smoke.JACOBIAN_EDGES))
def test_each_edge_takes_its_branch(name):
    env = chip_smoke.JACOBIAN_EDGES[name]
    lo, hi, lam, prefix = _chain(env)
    clip = ("high" if lam > hi else "low" if lam < lo else "none")
    assert clip == {"lambda clipped high": "high",
                    "lambda clipped low": "low"}.get(name, "none"), (
        lo, lam, hi)
    batch, k = int(env[3]), int(env[4])
    masked = prefix[k:]
    # Past k the first state lands on -1e30 and the rest lie below it.
    assert masked.numel() == 0 or (
        float(masked[0]) == NEG_INF and bool((masked[1:] < NEG_INF).all()))
    assert bool(torch.isfinite(prefix).all())
    want = {"k = 1": k == 1, "k = B": k == batch, "k = 2048": k == qm.K_MAX,
            "no prompt": env[1] == 0.0, "output under one token": env[2] < 1}
    assert want.get(name, True), env


def test_the_headline_point_is_the_tuner_steps():
    """The clipped-high edge is chip_smoke's timed tuner step: 1 state past
    k on -1e30 and 1,567 below it."""
    _, _, _, prefix = _chain(chip_smoke.TUNER_ENV)
    assert chip_smoke.JACOBIAN_EDGES["lambda clipped high"] == \
        chip_smoke.TUNER_ENV
    assert int((prefix == NEG_INF).sum()) == 1
    assert int((prefix < NEG_INF).sum()) == 1567


def _torch_rule(op, x, y):
    """torch.func.jvp of torch.maximum, torch.minimum or clamp(min=) on one
    tangent direction at a time: the value and three tangents."""
    fn = {0: torch.maximum, 1: torch.minimum,
          2: lambda a, b: torch.clamp(a, min=float(y[0]))}[op]
    out = [None] * 4
    for i in range(1, 4):
        tangents = (torch.tensor(x[i]), torch.tensor(y[i] if op != 2 else 0.0))
        v, t = torch.func.jvp(fn, (torch.tensor(x[0]), torch.tensor(y[0])),
                              tangents)
        out[0], out[i] = float(v), float(t)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("op", [0, 1, 2], ids=["maximum", "minimum", "clamp"])
@pytest.mark.parametrize("values", [(1.5, 1.5), (2.0, 1.0), (1.0, 2.0)],
                         ids=["tie", "x above", "x below"])
def test_forward_rules_at_ties(host, op, values):
    """maximum and minimum split a tie's tangent half and half; clamp(min=)
    passes the tangent at equality."""
    x = np.asarray([values[0], 3.0, -5.0, 0.25], np.float32)
    y = np.asarray([values[1], -1.0, 7.0, 2.0], np.float32)
    out = np.empty(4, np.float32)
    host.host_rule(op, as_ptr(x), as_ptr(y), as_ptr(out))
    np.testing.assert_array_equal(out, _torch_rule(op, x, y))


def test_cpu_tensors_take_the_plain_version():
    x = torch.tensor(chip_smoke.TUNER_X, dtype=torch.float32)
    env = torch.tensor(chip_smoke.TUNER_ENV, dtype=torch.float32)
    jacobian_kernel.launches = 0
    h, jac = tuner._observe_and_jacobian(x, env)
    want_h, want_jac = tuner.observe_and_jacobian_plain(x, env)
    assert torch.equal(h, want_h) and torch.equal(jac, want_jac)
    assert jacobian_kernel.launches == 0


@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "cpu"),
                                     ("meta", "meta")])
def test_tensors_off_the_cpu_go_to_the_kernel_or_raise(devices):
    """Anything but two CPU tensors goes to the kernel's launch, which
    takes only CUDA tensors on one card: mixed devices raise, and no
    launch is counted."""
    x = torch.zeros(3, dtype=torch.float32, device=devices[0])
    env = torch.zeros(5, dtype=torch.float32, device=devices[1])
    jacobian_kernel.launches = 0
    with pytest.raises(ValueError):
        tuner._observe_and_jacobian(x, env)
    assert jacobian_kernel.launches == 0


def test_the_bound_is_counted_from_the_work():
    work = jacobian_kernel.work(operations=0)
    assert work.bytes == 4 * (3 + 5 + 2 + 6)
    ms, term = work.bound()
    assert term == "chain" and ms == pytest.approx(
        jacobian_kernel.CHAIN_OPS * 4 / 1.98e9 * 1e3)
