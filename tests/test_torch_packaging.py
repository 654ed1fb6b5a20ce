"""The port as it is installed: the wheel built from the repository ships
every kernel source and header and the ``wva-tpu-torch`` command, and the
installed port, run outside the repository, builds its kernels in the
user's cache and sizes a batch as the checkout does.

The wheel is built from a copy of the tree in a temporary directory, by
``chip_smoke.py``'s phase 9 helpers, so that no ``build/`` or
``*.egg-info`` appears in the checkout. ``pip`` runs offline: no index, no
cache, no version check. ``cuda_build.build_dir``'s rule is tested on its
own, and racing builds with a stand-in for ``nvcc``.
"""

import os
import subprocess
import sys
import threading
import zipfile
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from wva_tpu_torch import cuda_build

REPO = Path(__file__).resolve().parents[1]
LIBRARIES = chip_smoke.kernel_libraries()

# Run in the installed port with ``python -c`` (as __main__), and exec'd
# here for the checkout's side of the comparison.
CHILD = '''
import json
import os
import sys

import numpy as np

LIBRARIES = ("sizing", "setup", "stats", "fit", "scan")


def sized():
    """size_batch on seeded CPU candidates (64 rows, k up to 480, k_cols
    512), on one thread: name -> numpy array. (On several threads a CPU
    sum over a row's states is split among them as they come free, and
    its last bit can differ from run to run.)"""
    import torch

    from wva_tpu_torch.analyzers.queueing import queue_model as qm

    rng = np.random.default_rng(20261017)
    c = 64
    cand = qm.candidate_batch(
        rng.uniform(3.0, 30.0, c), rng.uniform(0.001, 0.05, c),
        rng.uniform(0.00001, 0.002, c), rng.uniform(64, 2048, c),
        rng.uniform(32, 1024, c), rng.integers(1, 97, c),
        rng.integers(96, 481, c), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = qm.size_batch(cand, rng.uniform(100, 3000, c),
                            rng.uniform(5, 100, c), np.zeros(c), k_cols=512)
    finally:
        torch.set_num_threads(threads)
    return {k: v.numpy() for k, v in out.items()}


if __name__ == "__main__":
    import wva_tpu_torch
    from wva_tpu_torch.analyzers.queueing import (
        _build, chain_setup, chain_stats)
    from wva_tpu_torch.forecast import fit_kernel
    from wva_tpu_torch.sweep import scan_kernel

    np.savez(sys.argv[1], **sized())
    paths = {}
    for name, lib in zip(LIBRARIES, (
            _build.LIBRARY, chain_setup.LIBRARY, chain_stats.LIBRARY,
            fit_kernel.LIBRARY, scan_kernel.LIBRARY)):
        try:
            paths[name] = str(lib.path())
        except Exception as e:  # reported per library to the test
            paths[name] = f"{type(e).__name__}: {e}"
    print(json.dumps({
        "package": os.path.dirname(wva_tpu_torch.__file__),
        "paths": paths,
        "modules": sorted({m.split(".")[0] for m in sys.modules}),
        "port_files": sorted(
            m.__file__ for name, m in list(sys.modules.items())
            if name.split(".")[0] == "wva_tpu_torch"
            and getattr(m, "__file__", None))}))
'''


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The wheel built from a copy of the tree, as phase 9 builds it."""
    tmp = tmp_path_factory.mktemp("wheel")
    (tmp / "src").mkdir()
    chip_smoke.copy_wheel_sources(tmp / "src")
    chip_smoke.pip("wheel", "--no-build-isolation", "-w", str(tmp / "dist"),
                   str(tmp / "src"))
    (path,) = (tmp / "dist").glob("*.whl")
    return path


@pytest.fixture(scope="module")
def names(wheel):
    with zipfile.ZipFile(wheel) as z:
        return set(z.namelist())


@pytest.fixture(scope="module")
def site(wheel, tmp_path_factory):
    """The wheel installed with ``--target``."""
    target = tmp_path_factory.mktemp("site")
    chip_smoke.pip("install", "--target", str(target), str(wheel))
    return target


@pytest.fixture(scope="module")
def child_env(site, tmp_path_factory):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(site), JAX_PLATFORMS="cpu",
               XDG_CACHE_HOME=str(tmp_path_factory.mktemp("cache")))
    return env


@pytest.fixture(scope="module")
def child(site, child_env, tmp_path_factory):
    """CHILD run outside the repository with only the install on its
    path: its report, and its size_batch outputs."""
    import json

    run = tmp_path_factory.mktemp("run")
    npz = run.parent / "installed.npz"
    proc = subprocess.run([sys.executable, "-c", CHILD, str(npz)], cwd=run,
                          env=child_env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(npz) as arrays:
        report["sized"] = {k: arrays[k] for k in arrays.files}
    return report


def _files_under(root, pred):
    return {p.relative_to(REPO).as_posix() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and pred(p)}


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_wheel_ships_each_librarys_source_and_headers(names, name):
    lib = LIBRARIES[name]
    for path in (lib.source, *lib.depends):
        assert path.relative_to(REPO).as_posix() in names, path.name


def test_wheel_ships_every_csrc_file(names):
    on_disk = _files_under(REPO / "wva_tpu_torch",
                           lambda p: p.parent.name == "csrc")
    assert {"wva_tpu_torch/analyzers/queueing/csrc/chain_common.cuh",
            "wva_tpu_torch/sweep/csrc/world_scan.cu"} <= on_disk
    assert {n for n in names if "/csrc/" in n} == on_disk


def test_wheel_names_both_commands(wheel, names):
    (entry_points,) = [n for n in names if n.endswith(".dist-info/"
                                                      "entry_points.txt")]
    with zipfile.ZipFile(wheel) as z:
        text = z.read(entry_points).decode()
    assert "wva-tpu = wva_tpu.__main__:main" in text
    assert "wva-tpu-torch = wva_tpu_torch.__main__:main" in text


def test_wheel_holds_no_build_outputs(names):
    assert not [n for n in names
                if n.split("/")[0] == "build" or n.endswith(".so")
                or ".egg-info/" in n]


def test_wheel_keeps_the_reference_package(wheel, names):
    # Every file of wva_tpu/ ships as it is on disk, and nothing else of it.
    on_disk = _files_under(REPO / "wva_tpu", lambda p: p.suffix != ".pyc")
    assert {n for n in names if n.startswith("wva_tpu/")} == on_disk
    with zipfile.ZipFile(wheel) as z:
        for n in sorted(on_disk):
            assert z.read(n) == (REPO / n).read_bytes(), n


def test_wheel_ships_every_port_module(names):
    on_disk = _files_under(REPO / "wva_tpu_torch",
                           lambda p: p.suffix == ".py")
    assert on_disk <= names


def test_wheel_build_leaves_the_checkout_clean(wheel):
    assert not (REPO / "build" / "lib").exists()
    assert not list(REPO.glob("*.egg-info"))


def test_installed_port_is_the_install(child, site):
    assert Path(child["package"]).resolve() == (site / "wva_tpu_torch"
                                                ).resolve()
    assert child["port_files"]
    for f in child["port_files"]:
        assert Path(f).resolve().is_relative_to(site.resolve()), f
    assert not {"jax", "wva_tpu"} & set(child["modules"])


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_installed_library_builds_in_the_user_cache(child, child_env, name):
    path = Path(child["paths"][name])
    kernels = Path(child_env["XDG_CACHE_HOME"]) / "wva_tpu_torch" / "kernels"
    assert path.parent == kernels, child["paths"][name]
    # The same name as the checkout's: a hash of the same sources and flags.
    assert path.name == LIBRARIES[name].path().name


def test_installed_size_batch_equals_the_checkouts(child):
    ns = {"__name__": "checkout"}
    exec(CHILD, ns)
    mine = ns["sized"]()
    theirs = child["sized"]
    assert sorted(theirs) == sorted(mine)
    for key in mine:
        assert theirs[key].dtype == mine[key].dtype, key
        assert theirs[key].tobytes() == mine[key].tobytes(), key


def test_installed_command_runs(site, child_env, tmp_path):
    proc = subprocess.run([str(site / "bin" / "wva-tpu-torch"), "--help"],
                          cwd=tmp_path, env=child_env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--metrics-bind-address" in proc.stdout


def test_build_dir_in_a_checkout(tmp_path):
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    (tmp_path / "wva_tpu_torch").mkdir()
    out = cuda_build.build_dir(tmp_path / "wva_tpu_torch")
    assert out == tmp_path / "build" / "kernels" and out.is_dir()


def test_build_dir_of_this_checkout():
    assert cuda_build.build_dir() == REPO / "build" / "kernels"
    assert LIBRARIES["sizing"].path().parent == REPO / "build" / "kernels"


def test_build_dir_installed_uses_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    (tmp_path / "site" / "wva_tpu_torch").mkdir(parents=True)
    out = cuda_build.build_dir(tmp_path / "site" / "wva_tpu_torch")
    assert out == tmp_path / "cache" / "wva_tpu_torch" / "kernels"
    assert out.is_dir() and not (tmp_path / "site" / "build").exists()


def test_build_dir_installed_without_xdg_uses_home(tmp_path, monkeypatch):
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    out = cuda_build.build_dir(tmp_path / "site" / "wva_tpu_torch")
    assert out == tmp_path / "home" / ".cache" / "wva_tpu_torch" / "kernels"
    assert out.is_dir()


def test_build_dir_raises_when_the_cache_cannot_be_made(tmp_path,
                                                         monkeypatch):
    # A file where the cache's directory should be: creation fails for any
    # user, root included.
    (tmp_path / "blocked").write_text("")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "blocked"))
    with pytest.raises(RuntimeError, match=str(tmp_path / "blocked")):
        cuda_build.build_dir(tmp_path / "site" / "wva_tpu_torch")


FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: creates the -o file, waits, then copies the source (the
# last argument) into it, so that builds of one library overlap.
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
  src="$a"
done
: > "$out"
for i in 1 2 3 4 5; do sleep 0.02; done
cat "$src" >> "$out"
echo "ptxas info    : built $src"
"""


def test_racing_builds_leave_one_whole_library(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    kernels = tmp_path / "kernels"
    kernels.mkdir()
    monkeypatch.setattr(cuda_build, "cuda_tool", lambda name: str(nvcc))
    monkeypatch.setattr(cuda_build, "build_dir", lambda: kernels)
    source = tmp_path / "race.cu"
    source.write_text("// a kernel source\n" * 200)
    libs = [cuda_build.Library(source, lambda lib: None) for _ in range(8)]
    barrier = threading.Barrier(len(libs))
    paths, errors = [], []

    def build(lib):
        barrier.wait(timeout=30)
        try:
            paths.append(lib.build())
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1
    (out,) = set(paths)
    assert out.read_bytes() == source.read_bytes()
    assert sorted(p.name for p in kernels.iterdir()) == sorted(
        [out.name, out.with_suffix(".log").name])
    assert "ptxas info" in out.with_suffix(".log").read_text()
