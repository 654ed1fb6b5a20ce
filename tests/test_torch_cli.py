"""The port's CLI and host copies against the JAX package's.

- ``forecast backtest`` (``run_backtest`` and ``python -m wva_tpu_torch
  forecast backtest``) passes the committed golden gate on
  ``tests/goldens/forecast_trace_v1.jsonl``, as ``tests/test_forecast.py``
  holds the reference, and its report equals the reference's (every
  forecaster's scores a model at rtol 2e-3);
- the CLI's ``sweep`` writes the recommendations artifact the backtest's
  ``--knobs`` reads (``tests/test_sweep_cli.py``);
- helmlite renders ``charts/`` byte for byte as the reference's does;
- ``RestKubeClient`` round-trips objects through the port's fake API
  server (two cases of ``tests/test_rest_client.py``);
- ``fit_profile.validate`` gives the reference's verdicts, NIS at rtol
  2e-3;
- on the card, ``python -m wva_tpu_torch`` runs the controller against
  the fake API server and Prometheus and scales up over HTTP (the
  full-stack case of ``tests/test_subprocess_e2e.py``).

The reference is imported inside each CPU test, so a machine without jax
can collect this file: ``python -m pytest --noconftest
tests/test_torch_cli.py -m cuda``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from wva_tpu_torch.__main__ import main as wva_main

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens"
TRACE = str(GOLDENS / "forecast_trace_v1.jsonl")
REPORT = str(GOLDENS / "forecast_backtest_v1.json")
CHART = str(ROOT / "charts" / "wva-tpu")
CPU = "cpu"


def test_backtest_passes_the_golden_gate():
    from wva_tpu_torch.forecast.backtest import compare_to_golden, run_backtest

    report = run_backtest(TRACE, lead=90.0, period=600.0, grid_step=5.0,
                          min_history=90.0, device=CPU)
    with open(REPORT, encoding="utf-8") as f:
        golden = json.load(f)
    assert compare_to_golden(report, golden) == []
    assert report["seasonal_beats_linear"]


def test_backtest_report_equals_the_reference():
    from wva_tpu.forecast.backtest import run_backtest as ref_run_backtest
    from wva_tpu_torch.forecast.backtest import compare_to_golden, run_backtest

    args = dict(lead=90.0, period=600.0, grid_step=5.0, min_history=90.0)
    got = run_backtest(TRACE, device=CPU, **args)
    want = ref_run_backtest(TRACE, **args)
    assert compare_to_golden(got, want) == []
    assert ({k: v for k, v in got.items() if k not in ("models", "aggregate")}
            == {k: v for k, v in want.items()
                if k not in ("models", "aggregate")})
    assert got["models"].keys() == want["models"].keys()
    for key, per_model in want["models"].items():
        assert got["models"][key].keys() == per_model.keys()
        for name, stats in per_model.items():
            assert got["models"][key][name] == pytest.approx(stats,
                                                             rel=2e-3)


def test_cli_backtest_passes_the_golden_gate(capsys):
    rc = wva_main(["forecast", "backtest", TRACE, "--lead", "90",
                   "--period", "600", "--grid-step", "5", "--golden",
                   REPORT], device=CPU)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "BACKTEST GOLDEN OK" in out


def test_cli_sweep_artifact_feeds_the_backtest(tmp_path, capsys):
    path = str(tmp_path / "recs.json")
    assert wva_main(["sweep", "--smoke", "--sweep-seed", "7", "--out",
                     path], device=CPU) == 0
    capsys.readouterr()
    rc = wva_main(["forecast", "backtest", TRACE, "--knobs", path,
                   "--json"], device=CPU)
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["knobs"]["recommended_forecaster"]
    assert "backtest_validates" in report["knobs"]
    assert wva_main(["forecast", "backtest", TRACE, "--knobs",
                     str(tmp_path / "missing.json")], device=CPU) == 2


@pytest.mark.parametrize("set_values", [
    {}, {"controller.enabled": "false"},
    {"wva.metrics.auth": "true", "wva.namespaceScoped": "true",
     "wva.imagePullPolicy": "IfNotPresent"}],
    ids=["defaults", "client-only", "auth-scoped"])
def test_helmlite_renders_the_chart_as_the_reference(set_values):
    from wva_tpu.utils.helmlite import Renderer as RefRenderer
    from wva_tpu_torch.utils.helmlite import Renderer

    port = Renderer(CHART, set_values=dict(set_values))
    ref = RefRenderer(CHART, set_values=dict(set_values))
    assert port.render_chart() == ref.render_chart()
    assert (port.render_manifest(include_crds=True)
            == ref.render_manifest(include_crds=True))
    assert port.render_docs() == ref.render_docs()


@pytest.fixture()
def rest_world():
    from wva_tpu_torch.k8s.client import FakeCluster
    from wva_tpu_torch.k8s.fake_apiserver import FakeAPIServer
    from wva_tpu_torch.k8s.kubeconfig import Credentials
    from wva_tpu_torch.k8s.rest import RestKubeClient

    cluster = FakeCluster()
    server = FakeAPIServer(cluster).start()
    client = RestKubeClient(Credentials(server=server.url), timeout=5.0)
    yield cluster, server, client
    client.stop()
    server.shutdown()


def test_rest_va_status_roundtrip(rest_world):
    from wva_tpu_torch.api.v1alpha1 import (
        CrossVersionObjectReference, ObjectMeta, OptimizedAlloc,
        VariantAutoscaling, VariantAutoscalingSpec)
    from wva_tpu_torch.k8s.objects import clone

    _, _, client = rest_world
    client.create(VariantAutoscaling(
        metadata=ObjectMeta(name="v", namespace="inference"),
        spec=VariantAutoscalingSpec(
            scale_target_ref=CrossVersionObjectReference(name="v"),
            model_id="m")))
    got = clone(client.get("VariantAutoscaling", "inference", "v"))
    got.status.desired_optimized_alloc = OptimizedAlloc(
        accelerator="v5e-8", num_replicas=2)
    client.update_status(got)
    back = client.get("VariantAutoscaling", "inference", "v")
    assert back.status.desired_optimized_alloc.accelerator == "v5e-8"
    assert back.status.desired_optimized_alloc.num_replicas == 2
    assert back.spec.model_id == "m"


def test_rest_update_conflict_on_stale_resource_version(rest_world):
    from wva_tpu_torch.api.v1alpha1 import ObjectMeta
    from wva_tpu_torch.k8s.client import ConflictError
    from wva_tpu_torch.k8s.objects import (
        Container, Deployment, DeploymentStatus, PodTemplateSpec, clone)

    _, _, client = rest_world
    client.create(Deployment(
        metadata=ObjectMeta(name="llama-v5e", namespace="inference",
                            labels={"app": "llama"}),
        replicas=2, selector={"app": "llama"},
        template=PodTemplateSpec(labels={"app": "llama"},
                                 containers=[Container(name="srv")]),
        status=DeploymentStatus(replicas=2, ready_replicas=1)))
    a = clone(client.get("Deployment", "inference", "llama-v5e"))
    b = clone(client.get("Deployment", "inference", "llama-v5e"))
    a.replicas = 5
    client.update(a)
    b.replicas = 7
    with pytest.raises(ConflictError):
        client.update(b)
    assert client.get("Deployment", "inference", "llama-v5e").replicas == 5


def test_fit_profile_validates_as_the_reference():
    from wva_tpu.tools import fit_profile as ref_fp
    from wva_tpu_torch.tools import fit_profile as fp

    true, batch, avg_in, avg_out = (18.0, 0.00267, 0.00002), 96, 512.0, 256.0

    def point(b, parms):
        ttft_row, itl_row = fp.design_rows(b, avg_in, avg_out)
        return (sum(c * p for c, p in zip(ttft_row, parms)),
                sum(c * p for c, p in zip(itl_row, parms)))

    sync, saturated = point(1.0, true), point(float(batch), true)
    parms = fp.fit(*sync, *saturated, batch, avg_in, avg_out)
    assert parms == ref_fp.fit(*sync, *saturated, batch, avg_in, avg_out)
    service_s = (saturated[0] + avg_out * saturated[1]) / 1000.0
    observations = [("sync", 1.0 / service_s, sync),
                    ("mid-load", (batch // 2) / service_s,
                     point(batch // 2, true)),
                    ("off", 0.5 / service_s, point(1.0, (30.0, 0.01, 0.0)))]
    got = fp.validate(parms, observations, batch, avg_in, avg_out,
                      device=CPU)
    want = ref_fp.validate(parms, observations, batch, avg_in, avg_out)
    assert got["ok"] == want["ok"]
    assert [p["nis_ok"] for p in got["points"]] == [
        p["nis_ok"] for p in want["points"]]
    assert not all(p["nis_ok"] for p in got["points"]), \
        "the off-profile point must fail the NIS gate"
    for g, w in zip(got["points"], want["points"]):
        assert g["nis"] == pytest.approx(w["nis"], rel=2e-3, abs=1e-3)
        assert g["predicted_ttft_ms"] == pytest.approx(
            w["predicted_ttft_ms"], rel=2e-3)


# -- on the card: ``python -m wva_tpu_torch`` over HTTP ---------------------

NS = "inf"
SYSTEM_NS = "wva-system"
MODEL = "meta-llama/Llama-3.1-8B"
DEADLINE = 120.0

# The port runs without PyYAML. The controller parses YAML only in the
# kubeconfig and the ConfigMaps, which this test writes as JSON (a subset of
# YAML); where PyYAML is missing, the subprocess gets this JSON-only module
# in its place.
_YAML_SUBSET = '''
import json


class YAMLError(ValueError):
    pass


def safe_load(stream):
    text = stream.read() if hasattr(stream, "read") else stream
    try:
        return json.loads(text) if text.strip() else None
    except ValueError as e:
        raise YAMLError(str(e)) from e
'''


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


def _seed_cluster(cluster):
    from wva_tpu_torch.api import (
        ObjectMeta, VariantAutoscaling, VariantAutoscalingSpec)
    from wva_tpu_torch.api.v1alpha1 import CrossVersionObjectReference
    from wva_tpu_torch.emulator.profiles import add_tpu_nodepool
    from wva_tpu_torch.k8s import (
        ConfigMap, Container, Deployment, DeploymentStatus, ExtensionRef,
        InferencePool, Pod, PodStatus, PodTemplateSpec,
        ResourceRequirements, Service)

    add_tpu_nodepool(cluster, "v5e-pool", "v5e", "2x4", 8)
    cluster.create(Deployment(
        metadata=ObjectMeta(name="llama-v5e", namespace=NS),
        replicas=1, selector={"app": "llama"},
        template=PodTemplateSpec(
            labels={"app": "llama"},
            containers=[Container(
                name="srv", args=["--max-num-seqs=256"],
                resources=ResourceRequirements(
                    requests={"google.com/tpu": "8"}))]),
        status=DeploymentStatus(replicas=1, ready_replicas=1)))
    cluster.create(VariantAutoscaling(
        metadata=ObjectMeta(
            name="llama-v5e", namespace=NS,
            labels={"inference.optimization/acceleratorName": "v5e-8"}),
        spec=VariantAutoscalingSpec(
            scale_target_ref=CrossVersionObjectReference(name="llama-v5e"),
            model_id=MODEL, variant_cost="10.0")))
    cluster.create(Pod(
        metadata=ObjectMeta(
            name="llama-v5e-0", namespace=NS, labels={"app": "llama"},
            owner_references=[{"kind": "Deployment", "name": "llama-v5e"}]),
        status=PodStatus(phase="Running", ready=True, pod_ip="10.0.0.1")))
    cluster.create(Service(metadata=ObjectMeta(name="epp-svc", namespace=NS),
                           selector={"app": "epp"}))
    cluster.create(InferencePool(
        metadata=ObjectMeta(name="llama-pool", namespace=NS),
        selector={"app": "llama"},
        extension_ref=ExtensionRef(service_name="epp-svc")))
    cluster.create(ConfigMap(
        metadata=ObjectMeta(name="wva-saturation-scaling-config",
                            namespace=SYSTEM_NS),
        data={"default": json.dumps({"kvCacheThreshold": 0.8,
                                     "queueLengthThreshold": 5})}))


def _feed(db, stop):
    """Saturated vLLM series, re-stamped every 3 s on the system clock."""
    labels = {"pod": "llama-v5e-0", "namespace": NS, "model_name": MODEL}
    while not stop.is_set():
        now = time.time()
        db.add_sample("vllm:kv_cache_usage_perc", labels, 0.95, now)
        db.add_sample("vllm:num_requests_waiting", labels, 30, now)
        db.add_sample("vllm:cache_config_info",
                      {**labels, "num_gpu_blocks": "4096",
                       "block_size": "32"}, 1.0, now)
        stop.wait(3.0)


def _wait_for(predicate, deadline, what):
    end = time.time() + deadline
    last_err = None
    while time.time() < end:
        try:
            value = predicate()
            if value:
                return value
        except Exception as e:  # noqa: BLE001 — poll through startup races
            last_err = e
        time.sleep(0.5)
    raise AssertionError(f"timed out waiting for {what}: {last_err}")


def _http_get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


def _spawn_controller(kubeconfig, prom_url, shim_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    try:
        import yaml  # noqa: F401
    except ImportError:
        env["PYTHONPATH"] = shim_dir
    env.update({"PROMETHEUS_BASE_URL": prom_url,
                "GLOBAL_OPT_INTERVAL": "2s", "POD_NAMESPACE": SYSTEM_NS})
    return subprocess.Popen(
        [sys.executable, "-m", "wva_tpu_torch", "--kubeconfig", kubeconfig,
         "--metrics-bind-address", "127.0.0.1:0",
         "--health-probe-bind-address", "127.0.0.1:0", "-v", "2",
         "--leader-elect"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _ports(proc, output):
    pattern = re.compile(r"Serving /metrics on :(\d+) and /healthz /readyz "
                         r"on :(\d+)")
    end = time.time() + DEADLINE
    while time.time() < end:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                break
            continue
        output.append(line)
        m = pattern.search(line)
        if m:
            return int(m.group(1)), int(m.group(2))
    raise AssertionError("controller never announced its ports; output:\n"
                         + "".join(output))


@pytest.mark.cuda
def test_controller_scales_up_over_http_on_the_card(cuda, tmp_path):
    from wva_tpu_torch.collector.source import TimeSeriesDB
    from wva_tpu_torch.emulator.prom_server import FakePrometheusServer
    from wva_tpu_torch.k8s import FakeCluster
    from wva_tpu_torch.k8s.fake_apiserver import FakeAPIServer

    cluster = FakeCluster()
    _seed_cluster(cluster)
    apiserver = FakeAPIServer(cluster).start()
    db = TimeSeriesDB()
    stop = threading.Event()
    feeder = threading.Thread(target=_feed, args=(db, stop), daemon=True)
    feeder.start()
    prom = FakePrometheusServer(db)
    prom.start()
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "fake", "cluster": {"server": apiserver.url}}],
        "contexts": [{"name": "fake",
                      "context": {"cluster": "fake", "user": "fake"}}],
        "current-context": "fake",
        "users": [{"name": "fake", "user": {}}]}))
    shim = tmp_path / "shim"
    shim.mkdir()
    (shim / "yaml.py").write_text(_YAML_SUBSET)
    proc = _spawn_controller(str(kubeconfig), prom.url, str(shim))
    output = []
    try:
        metrics_port, health_port = _ports(proc, output)
        threading.Thread(target=lambda: [output.append(x)
                                         for x in proc.stdout],
                         daemon=True).start()
        _wait_for(lambda: "ok" in _http_get(
            f"http://127.0.0.1:{health_port}/readyz"), 30.0, "readyz")

        def lease_held():
            return any(lease.holder_identity for lease in
                       cluster.list("Lease", namespace=SYSTEM_NS))
        _wait_for(lease_held, 30.0, "leader-election lease")

        def scaled_up():
            va = cluster.get("VariantAutoscaling", NS, "llama-v5e")
            return (va.status.desired_optimized_alloc.num_replicas or 0) >= 2
        _wait_for(scaled_up, DEADLINE, "VA status scale-up")

        def gauge_scaled():
            text = _http_get(f"http://127.0.0.1:{metrics_port}/metrics")
            return any(float(line.rsplit(" ", 1)[1]) >= 2
                       for line in text.splitlines()
                       if line.startswith("wva_desired_replicas")
                       and 'variant_name="llama-v5e"' in line)
        _wait_for(gauge_scaled, 30.0, "wva_desired_replicas gauge")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, "".join(output[-40:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stop.set()
        prom.shutdown()
        apiserver.shutdown()
