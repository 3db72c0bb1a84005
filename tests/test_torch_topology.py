"""The GPU twins of the reference's TPU-bound provisioning pieces
(``triton_kubernetes_tpu_torch/{topology,modules,workflows}``, the HCL
modules ``gcp-gpu-k8s``, ``gcp-gpu-nodepool``, ``gpu-jobset`` and the image
configs ``torch-cuda-runtime.yaml``, ``gpu-health-probe.yaml``), on the CPU.

Each renderer is held against the reference's rendering of the matching
TPU pool -- ``h100-8`` (one host of eight) against ``v5e-8`` (one host of
eight chips), ``h100-32`` (four hosts of eight) against ``v5p-16`` (four
hosts of four) -- by walking both dicts: every path must be equal except
the accelerator paths of ``ACCELERATOR_PATHS``, named once below. The
walk renames the GPU twins' keys to the reference's (``_KEY_TWINS``) and
keys lists of named objects (env, volumes, mounts, containers) by name,
so a path reads like ``... > env > TPU_CHIPS_PER_HOST``.
"""

import copy
import fnmatch
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from triton_kubernetes_tpu.config import Config, InputResolver
from triton_kubernetes_tpu.executor import LocalExecutor
from triton_kubernetes_tpu.executor.engine import delete_executor_state
from triton_kubernetes_tpu.executor.tf_validate import validate_module_dir
from triton_kubernetes_tpu.images.pipeline import load_template
from triton_kubernetes_tpu.state import StateDocument
from triton_kubernetes_tpu.topology import daemonsets as jds
from triton_kubernetes_tpu.topology import jobset as jjs
from triton_kubernetes_tpu.topology import labels as jlabels
from triton_kubernetes_tpu.topology import serving as jserving
from triton_kubernetes_tpu.topology.slices import SliceSpec
from triton_kubernetes_tpu.workflows.common import WorkflowContext
from triton_kubernetes_tpu.workflows.providers import gcp_tpu
from triton_kubernetes_tpu_torch.modules import gcp_gpu
from triton_kubernetes_tpu_torch.topology import daemonsets as ds
from triton_kubernetes_tpu_torch.topology import gpus
from triton_kubernetes_tpu_torch.topology import jobset as js
from triton_kubernetes_tpu_torch.topology import labels
from triton_kubernetes_tpu_torch.topology import serving
from triton_kubernetes_tpu_torch.topology.gpus import GpuPoolSpec
from triton_kubernetes_tpu_torch.train.__main__ import (
    DistributedEnvError, parse_distributed_env)
from triton_kubernetes_tpu_torch.workflows.providers import gcp_gpu as wf

ROOT = Path(__file__).resolve().parents[1]
TF = ROOT / "terraform" / "modules"
IMAGES = ROOT / "images"

# The pools compared: (GPU accelerator, TPU accelerator) with equal hosts
# and, for h100-8 / v5e-8, equal devices a host.
PAIRS = [("h100-8", "v5e-8"), ("h100-32", "v5p-16")]

# GPU key -> the reference's key at the same place.
_KEY_TWINS = {
    labels.GKE_ACCELERATOR_LABEL: jlabels.GKE_ACCELERATOR_LABEL,
    f"{labels.LABEL_PREFIX}/gpus-per-host":
        f"{jlabels.LABEL_PREFIX}/chips-per-host",
    "nvidia.com/gpu": "google.com/tpu",
    "GPUS_PER_HOST": "TPU_CHIPS_PER_HOST",
    "num_gpus": "num_chips",
    "gpu_accelerator": "tpu_accelerator",
    "gpu": "tpu",  # the HCL node pool resource's name
    "gpu_daemonsets": "tpu_daemonsets",
}

# The accelerator paths, the only places a twin may differ from the
# reference (fnmatch patterns over paths joined by " > ").
ACCELERATOR_PATHS = (
    # resource names and the labels and selectors of devices and hosts
    "metadata > name", "* > matchLabels > app", "* > labels > app",
    f"* > {jlabels.GKE_ACCELERATOR_LABEL}",
    f"* > {jlabels.GKE_TOPOLOGY_LABEL}",
    f"* > {jlabels.LABEL_PREFIX}/chips-per-host",
    f"* > {jlabels.LABEL_PREFIX}/generation",
    f"* > {jlabels.LABEL_PREFIX}/ici-*",
    f"* > {jlabels.LABEL_PREFIX}/accelerator",
    f"{jlabels.GKE_ACCELERATOR_LABEL}", f"{jlabels.GKE_TOPOLOGY_LABEL}",
    f"{jlabels.LABEL_PREFIX}/chips-per-host",
    f"{jlabels.LABEL_PREFIX}/generation", f"{jlabels.LABEL_PREFIX}/ici-*",
    "* > node.kubernetes.io/instance-type",
    # device resources
    "* > limits > google.com/tpu",
    # images
    "* > image",
    # probe commands and the train/serve commands
    "* > command", "* > exec > command",
    # TPU env values and the runtime's host mounts
    "* > env > TPU_CHIPS_PER_HOST", "* > env > TPU_TOPOLOGY",
    "* > env > TPU_CHIP_COUNT", "* > env > FAIL_ON_INIT_ERROR",
    "* > volumeMounts > libtpu", "* > volumeMounts > nvidia",
    "* > volumes > libtpu", "* > volumes > nvidia",
)


def _keyed(items):
    """A list of named objects as a dict by name, else the list."""
    if items and all(isinstance(x, dict) and "name" in x for x in items):
        return {x["name"]: x for x in items}
    return items


def _twin_key(key):
    """The reference's name for a GPU twin's key."""
    if key in _KEY_TWINS:
        return _KEY_TWINS[key]
    if key.startswith(labels.LABEL_PREFIX + "/"):
        return jlabels.LABEL_PREFIX + key[len(labels.LABEL_PREFIX):]
    return key


def _walk(a, b, path=()):
    """Paths (tuples) where a and b differ; GPU keys renamed on a's side."""
    if isinstance(a, dict) and isinstance(b, dict):
        a = {_twin_key(k): v for k, v in a.items()}
        out = []
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                out.append(path + (k,))
            else:
                out += _walk(a[k], b[k], path + (k,))
        return out
    if isinstance(a, list) and isinstance(b, list):
        ka, kb = _keyed(a), _keyed(b)
        if isinstance(ka, dict) and isinstance(kb, dict):
            return _walk(ka, kb, path)
        if len(a) != len(b):
            return [path]
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out += _walk(x, y, path + (str(i),))
        return out
    return [] if a == b else [path]


def _off_accelerator(paths, allowed=ACCELERATOR_PATHS):
    """The paths no accelerator pattern covers (a pattern covers a path
    when it matches the path or one of its prefixes)."""
    def covered(path):
        return any(fnmatch.fnmatchcase(" > ".join(path[:n]), pat)
                   for n in range(1, len(path) + 1) for pat in allowed)
    return [" > ".join(p) for p in paths if not covered(p)]


def assert_twins(gpu, tpu, allowed=ACCELERATOR_PATHS):
    """gpu equals tpu at every path but the accelerator paths; returns
    the paths that differ."""
    paths = _walk(gpu, tpu)
    bad = _off_accelerator(paths, allowed)
    assert not bad, bad
    return [" > ".join(p) for p in paths]


# ------------------------------------------------------------ gpus.py
def test_h100_peak_is_the_trainers():
    from triton_kubernetes_tpu_torch.train.mfu import PEAK_BF16_TFLOPS

    h100 = gpus.GPU_GENERATIONS["h100"]
    assert h100.peak_bf16_tflops == PEAK_BF16_TFLOPS["H100 SXM"]
    assert (h100.gpus_per_host, h100.hbm_gb_per_gpu, h100.gke_accelerator,
            h100.machine_type) == (8, 80.0, "nvidia-h100-80gb",
                                   "a3-highgpu-8g")


@pytest.mark.parametrize("name,hosts,per_host,machine", [
    ("h100-1", 1, 1, "a3-highgpu-1g"), ("h100-2", 1, 2, "a3-highgpu-2g"),
    ("h100-4", 1, 4, "a3-highgpu-4g"), ("h100-8", 1, 8, "a3-highgpu-8g"),
    ("h100-16", 2, 8, "a3-highgpu-8g"), ("h100-64", 8, 8, "a3-highgpu-8g")])
def test_pool_shape(name, hosts, per_host, machine):
    spec = GpuPoolSpec.from_accelerator(name)
    assert (spec.num_hosts, spec.gpus_per_host, spec.machine_type) == (
        hosts, per_host, machine)
    assert spec.num_hosts * spec.gpus_per_host == spec.gpus
    assert spec.is_multi_host == (hosts > 1)
    assert spec.accelerator == name
    assert spec.peak_bf16_tflops == spec.gpus * 989.0


@pytest.mark.parametrize("name", ["h100-3", "h100-12", "h100-0", "h100",
                                  "h100-x", "a100-8", "v5e-8", "h100-8192"])
def test_parse_accelerator_refuses(name):
    """As the reference refuses a chip count no host shape holds: 3 and 12
    GPUs are neither one A3 machine nor whole hosts."""
    with pytest.raises(ValueError):
        gpus.parse_accelerator(name)


# ----------------------------------------------------------- labels.py
@pytest.mark.parametrize("gpu,tpu", PAIRS)
def test_host_labels_twin_the_references(gpu, tpu):
    spec = GpuPoolSpec.from_accelerator(gpu)
    got = labels.host_labels_for_pool(spec, "ml-pool0")
    want = jlabels.host_labels_for_slice(SliceSpec.from_accelerator(tpu),
                                         "ml-pool0")
    assert len(got) == len(want) == spec.num_hosts
    for i, (g, w) in enumerate(zip(got, want)):
        differ = assert_twins(g, w)
        assert g[f"{labels.LABEL_PREFIX}/worker-id"] == str(i)
        # No torus: no topology or ICI coordinate label is invented.
        assert not any("ici" in k or "topology" in k for k in g)
        assert jlabels.GKE_TOPOLOGY_LABEL in differ
    assert got[0][labels.GKE_ACCELERATOR_LABEL] == "nvidia-h100-80gb"
    assert got[0][f"{labels.LABEL_PREFIX}/gpus-per-host"] == str(
        spec.gpus_per_host)


def test_verify_pool_labels_and_selector():
    spec = GpuPoolSpec.from_accelerator("h100-32")
    good = labels.host_labels_for_pool(spec, "ml-p")
    assert labels.verify_pool_labels(good, spec, "ml-p") == []
    shuffled = copy.deepcopy(good)
    shuffled[0], shuffled[1] = shuffled[1], shuffled[0]
    assert any("worker 0" in p for p in
               labels.verify_pool_labels(shuffled, spec, "ml-p"))
    assert labels.verify_pool_labels(good[:3], spec, "ml-p") == [
        "pool ml-p: 3 labeled hosts, expected 4"]
    sel = labels.selector_for_pool(spec, "ml-p")
    assert all(good[i][k] == v for i in range(4) for k, v in sel.items())
    assert_twins(sel, jlabels.selector_for_slice(
        SliceSpec.from_accelerator("v5p-16"), "ml-p"))


# ------------------------------------------------------- daemonsets.py
@pytest.mark.parametrize("gpu,tpu", PAIRS)
@pytest.mark.parametrize("which", ["runtime", "device-plugin", "health"])
def test_daemonsets_twin_the_references(gpu, tpu, which):
    spec = GpuPoolSpec.from_accelerator(gpu)
    ref = SliceSpec.from_accelerator(tpu)
    mine, theirs = {
        "runtime": (ds.render_gpu_runtime_daemonset,
                    jds.render_tpu_runtime_daemonset),
        "device-plugin": (ds.render_gpu_device_plugin,
                          jds.render_tpu_device_plugin),
        "health": (ds.render_gpu_health_daemonset,
                   jds.render_slice_health_daemonset)}[which]
    got = mine(spec)
    differ = assert_twins(got, theirs(ref))
    assert "metadata > name" in differ
    name = got["metadata"]["name"]
    assert name.endswith(f"-{spec.machine_type}-{spec.gpus_per_host}g")
    pod = got["spec"]["template"]["spec"]
    assert pod["nodeSelector"] == {
        labels.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb",
        "node.kubernetes.io/instance-type": spec.machine_type,
        f"{labels.LABEL_PREFIX}/gpus-per-host": str(spec.gpus_per_host)}


def test_health_probe_asserts_the_grant():
    for name in ("h100-1", "h100-8", "h100-16"):
        spec = GpuPoolSpec.from_accelerator(name)
        probe = ds.render_gpu_health_daemonset(spec)[
            "spec"]["template"]["spec"]["containers"][0]
        want = ["python", "-c", "import torch; assert "
                f"torch.cuda.device_count() == {spec.gpus_per_host}"]
        assert probe["command"] == probe["readinessProbe"]["exec"][
            "command"] == want == ds.health_command(spec.gpus_per_host)


def test_health_command_runs_here_and_fails_for_more_gpus():
    """On this card-less machine torch sees 0 GPUs: the command rendered
    for 0 exits 0, the one for 1 exits non-zero (the card runs the same
    pair for 1 and 2)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    ok = subprocess.run([sys.executable, *ds.health_command(0)[1:]],
                        env=env, capture_output=True)
    bad = subprocess.run([sys.executable, *ds.health_command(1)[1:]],
                         env=env, capture_output=True)
    assert ok.returncode == 0, ok.stderr
    assert bad.returncode != 0 and b"AssertionError" in bad.stderr


def test_device_plugin_advertises_nvidia_gpu_through_the_jobset():
    spec = GpuPoolSpec.from_accelerator("h100-16")
    job = js.render_jobset("t", spec, "ml-p", "img", ["true"])
    limits = job["spec"]["template"]["spec"]["containers"][0]["resources"][
        "limits"]
    assert limits == {"nvidia.com/gpu": "8"}


# ----------------------------------------------------------- jobset.py
def _env(job, index):
    """The worker container's env with the completion index resolved."""
    container = job["spec"]["template"]["spec"]["containers"][0]
    env = {}
    for e in container["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
        else:
            assert e["valueFrom"]["fieldRef"]["fieldPath"] == \
                js.COMPLETION_INDEX_FIELD
            env[e["name"]] = str(index)
    return env


@pytest.mark.parametrize("gpu,tpu", PAIRS)
@pytest.mark.parametrize("trace_dir", [None, "/var/log/tk8s"])
def test_jobset_twins_the_references(gpu, tpu, trace_dir):
    spec = GpuPoolSpec.from_accelerator(gpu)
    ref = SliceSpec.from_accelerator(tpu)
    args = ("train", "ml-pool0", "img:1", ["python", "-m", "x"])
    kw = dict(namespace="ns", env={"A": "1"}, trace_dir=trace_dir)
    got = js.render_jobset(args[0], spec, *args[1:], **kw)
    differ = assert_twins(got, jjs.render_jobset(args[0], ref, *args[1:],
                                                 **kw))
    assert any(p.endswith("env > TPU_TOPOLOGY") for p in differ)
    assert got["spec"]["template"]["spec"]["containers"][0]["resources"] == {
        "limits": {"nvidia.com/gpu": str(spec.gpus_per_host)}}
    assert_twins(js.render_headless_service("train", "ns"),
                 jjs.render_headless_service("train", "ns"))
    assert_twins(
        js.resize_jobset("train", spec, 3, image="i", command=["c"]),
        jjs.resize_jobset("train", ref, 3, image="i", command=["c"]))


@pytest.mark.parametrize("gpu", ["h100-1", "h100-8", "h100-16", "h100-32"])
def test_parse_distributed_env_reads_the_rendered_jobset(gpu):
    """The trainer's env contract: a pod a host, one rank a GPU. Host i's
    rendered env, its completion index resolved, with the LOCAL_RANK j
    the host launcher gives each of its GPUS_PER_HOST ranks, reads as rank
    i * g + j of a world of hosts * g on cuda:j, the rendezvous at worker
    0's stable name: every GPU of the pool is one rank, each on its own
    (host, cuda:j)."""
    spec = GpuPoolSpec.from_accelerator(gpu)
    job = js.render_jobset("train", spec, "ml-p", "img",
                           list(js.DEFAULT_TRAIN_COMMAND), namespace="ns")
    hosts, g = spec.num_hosts, spec.gpus_per_host
    assert job["spec"]["completions"] == hosts
    seats = {}
    for i in range(hosts):
        env = _env(job, i)
        assert env["GPUS_PER_HOST"] == str(g)
        for j in range(g):
            got = parse_distributed_env(dict(env, LOCAL_RANK=str(j)))
            assert got.num_processes == spec.gpus == hosts * g
            assert (got.process_id, got.local_rank) == (i * g + j, j)
            assert got.coordinator == "train-0.train.ns.svc:8476"
            seats[got.process_id] = (i, j)
        if g > 1:
            with pytest.raises(DistributedEnvError, match="LOCAL_RANK"):
                parse_distributed_env(env)
    assert sorted(seats) == list(range(spec.gpus))
    assert len(set(seats.values())) == spec.gpus
    container = job["spec"]["template"]["spec"]["containers"][0]
    assert container["command"] == js.HOST_LAUNCH + [
        "python", "-m", "triton_kubernetes_tpu_torch.train"]
    assert container["resources"] == {"limits": {"nvidia.com/gpu": str(g)}}
    with pytest.raises(ValueError, match="workers=0"):
        js.resize_jobset("t", spec, 0, image="i", command=["c"])


def _host_argv(command):
    """A rendered command as this host runs it: ``python`` is this
    interpreter."""
    return [sys.executable if a == "python" else a for a in command]


def test_host_launch_starts_a_rank_a_gpu_of_the_rendered_pod():
    """The rendered pod of host 1 of an h100-16 pool, run here: its
    command starts one process a GPU, LOCAL_RANK 0-7 under the pod's env,
    which read as ranks 8-15 of 16."""
    spec = GpuPoolSpec.from_accelerator("h100-16")
    show = ("import json, os; print(json.dumps({k: os.environ[k] for k in "
            "('LOCAL_RANK', 'TPU_WORKER_ID', 'NUM_TPU_WORKERS', "
            "'GPUS_PER_HOST')}))")
    job = js.render_jobset("train", spec, "ml-p", "img",
                           ["python", "-c", show])
    env = _env(job, 1)
    command = job["spec"]["template"]["spec"]["containers"][0]["command"]
    out = subprocess.run(_host_argv(command), cwd=ROOT,
                         env=dict(os.environ, **env), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = [json.loads(line) for line in out.stdout.splitlines()]
    assert sorted(int(e["LOCAL_RANK"]) for e in seen) == list(range(8))
    ranks = sorted(parse_distributed_env(dict(env, **e)).process_id
                   for e in seen)
    assert ranks == list(range(8, 16))


def test_host_launch_keeps_each_rank_line_whole_when_unbuffered():
    """F13: under ``PYTHONUNBUFFERED=1`` a rank's ``print`` writes the
    line and its newline apart. The rendered h100-16 pod's eight ranks
    each print 200 JSON lines to stdout and 200 plain lines to stderr:
    every stdout line parses, every rank gives 200, and stderr stays
    apart from stdout."""
    spec = GpuPoolSpec.from_accelerator("h100-16")
    show = ("import json, os, sys\n"
            "r = os.environ['LOCAL_RANK']\n"
            "for i in range(200):\n"
            "    print(json.dumps({'LOCAL_RANK': r, 'i': i, 'pad': 'x' * 64}))\n"
            "    print('err', r, i, file=sys.stderr)\n")
    job = js.render_jobset("train", spec, "ml-p", "img",
                           ["python", "-c", show])
    env = dict(_env(job, 1), PYTHONUNBUFFERED="1")
    command = job["spec"]["template"]["spec"]["containers"][0]["command"]
    out = subprocess.run(_host_argv(command), cwd=ROOT,
                         env=dict(os.environ, **env), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = [json.loads(line) for line in out.stdout.splitlines()]
    counts = {}
    for e in seen:
        counts[e["LOCAL_RANK"]] = counts.get(e["LOCAL_RANK"], 0) + 1
    assert counts == {str(r): 200 for r in range(8)}
    for r in range(8):
        mine = [e["i"] for e in seen if e["LOCAL_RANK"] == str(r)]
        assert mine == list(range(200))
    err = out.stderr.splitlines()
    assert len(err) == 8 * 200
    assert all(line.split()[0] == "err" and len(line.split()) == 3
               for line in err)


def test_host_launch_ends_a_killed_rank_partial_line(tmp_path):
    """A rank that dies mid-line leaves its partial line, ended with a
    newline, before the pod's exit code returns. Each rank dies only once
    both have written (a rank that ended first would have its sibling
    sent SIGTERM before it wrote)."""
    launch = [sys.executable, "-m",
              "triton_kubernetes_tpu_torch.parallel.host_launch", "--"]
    env = dict(os.environ, GPUS_PER_HOST="2", PYTHONUNBUFFERED="1")
    cut = ("import os, sys, time; r = os.environ['LOCAL_RANK']; "
           "sys.stdout.write('whole ' + r + '\\n'); "
           "sys.stdout.write('part' + r); "
           f"d = {str(tmp_path)!r}; open(os.path.join(d, r), 'w').close(); "
           "t = time.monotonic() + 30\n"
           "while len(os.listdir(d)) < 2 and time.monotonic() < t:\n"
           "    time.sleep(0.01)\n"
           "os._exit(4)")
    out = subprocess.run(launch + [sys.executable, "-c", cut], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 4
    assert out.stdout.endswith("\n")
    assert sorted(out.stdout.splitlines()) == ["part0", "part1",
                                               "whole 0", "whole 1"]


def test_host_launch_returns_when_a_rank_leaves_a_pipe_open():
    """A rank that leaves a process holding its stdout open (no EOF for
    60 s) still gives the pod its exit code within ``DRAIN_S`` of its
    end, with the lines it wrote."""
    from triton_kubernetes_tpu_torch.parallel import host_launch

    launch = [sys.executable, "-m",
              "triton_kubernetes_tpu_torch.parallel.host_launch", "--"]
    env = dict(os.environ, GPUS_PER_HOST="1", PYTHONUNBUFFERED="1")
    leave = ("import subprocess, sys; "
             "p = subprocess.Popen([sys.executable, '-c', "
             "'import time; time.sleep(60)']); print(p.pid); sys.exit(3)")
    t0 = time.monotonic()
    out = subprocess.run(launch + [sys.executable, "-c", leave], cwd=ROOT,
                         env=env, stdout=subprocess.PIPE, text=True,
                         timeout=50)
    (pid,) = out.stdout.split()
    os.kill(int(pid), signal.SIGKILL)
    assert out.returncode == 3
    assert time.monotonic() - t0 < host_launch.DRAIN_S + 20


def test_host_launch_passes_on_signals_and_the_first_failure():
    """A rank that exits non-zero gets its siblings a SIGTERM and gives
    the pod its code; a SIGTERM to the pod reaches every rank, whose
    EXIT_RESUME the pod exits with."""
    import signal
    import time

    launch = [sys.executable, "-m",
              "triton_kubernetes_tpu_torch.parallel.host_launch", "--"]
    env = dict(os.environ, GPUS_PER_HOST="3")
    fail = ("import os, sys, time; r = int(os.environ['LOCAL_RANK']); "
            "time.sleep(0.5) if r == 1 else None; "
            "sys.exit(3) if r == 1 else time.sleep(60)")
    t0 = time.monotonic()
    out = subprocess.run(launch + [sys.executable, "-c", fail], cwd=ROOT,
                         env=env, capture_output=True, timeout=60)
    assert out.returncode == 3 and time.monotonic() - t0 < 30
    wait = ("import signal, sys, time; signal.signal(signal.SIGTERM, "
            "lambda *a: sys.exit(75)); print('up', flush=True); "
            "time.sleep(60)")
    proc = subprocess.Popen(launch + [sys.executable, "-c", wait], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, text=True)
    for _ in range(3):
        assert proc.stdout.readline().strip() == "up"
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 75


def test_rendered_jobset_trains_a_world_of_its_gpus_on_the_cpu(tmp_path):
    """The rendered pod of an h100-2 pool (one host of two GPUs) run here
    as its container would, the trainer on the CPU: the host launcher
    starts two ranks that join one world of two (gloo) and train."""
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        pick_coordinator_port

    spec = GpuPoolSpec.from_accelerator("h100-2")
    report = tmp_path / "report.json"
    job = js.render_jobset("train", spec, "ml-p", "img", [
        *js.DEFAULT_TRAIN_COMMAND, "--model", "llama-test", "--device",
        "cpu", "--steps", "2", "--batch-size", "4", "--seq-len", "16",
        "--warmup-steps", "1", "--prefetch", "0", "--json-logs",
        "--report-json", str(report)])
    env = _env(job, 0)
    port = pick_coordinator_port(str(tmp_path))
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    command = job["spec"]["template"]["spec"]["containers"][0]["command"]
    out = subprocess.run(
        _host_argv(command), cwd=ROOT, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, **env, OMP_NUM_THREADS="1",
                              PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    # The two ranks share the pod's stderr, so their lines may interleave:
    # take each flat "distributed init" record wherever it lands.
    joined = sorted(
        (r["process_id"], r["num_processes"], r["local_rank"])
        for r in map(json.loads, re.findall(
            r'\{[^{}]*"msg": "distributed init"[^{}]*\}', out.stderr)))
    assert joined == [(0, 2, 0), (1, 2, 1)]
    got = json.loads(report.read_text())
    assert got["n_processes"] == 2 and len(got["losses"]) == 2


# ---------------------------------------------------------- serving.py
@pytest.mark.parametrize("gpu,tpu", PAIRS)
@pytest.mark.parametrize("pool", ["colocated", "prefill", "decode"])
def test_serving_deployment_twins_the_references(gpu, tpu, pool):
    spec = GpuPoolSpec.from_accelerator(gpu)
    ref = SliceSpec.from_accelerator(tpu)
    args = ("srv", "ml-p", "img", "llama3-8b")
    got = serving.render_serving_deployment(args[0], spec, *args[1:],
                                            replicas=2, env={"A": "1"},
                                            pool=pool)
    differ = assert_twins(got, jserving.render_serving_deployment(
        args[0], ref, *args[1:], replicas=2, env={"A": "1"}, pool=pool))
    assert any(p.endswith("server > command") for p in differ)
    container = got["spec"]["template"]["spec"]["containers"][0]
    # One card a replica: tools.serve drives one.
    assert container["resources"] == {"limits": {"nvidia.com/gpu": "1"}}
    assert container["command"][:3] == [
        "python", "-m", "triton_kubernetes_tpu_torch.tools.serve"]


def test_disaggregated_and_services_twin_the_references():
    spec = GpuPoolSpec.from_accelerator("h100-8")
    ref = SliceSpec.from_accelerator("v5e-8")
    for g, t in zip(
            serving.render_disaggregated_deployments(
                "s", spec, "p", "i", "m", 2, 3, env={"A": "1"}),
            jserving.render_disaggregated_deployments(
                "s", ref, "p", "i", "m", 2, 3, env={"A": "1"})):
        assert_twins(g, t)
    for headless in (False, True):
        assert serving.render_serving_service("s", headless=headless) == \
            jserving.render_serving_service("s", headless=headless)
    assert serving.render_router_service("r") == \
        jserving.render_router_service("r")
    assert serving.render_operator_service("o") == \
        jserving.render_operator_service("o")
    assert serving.render_operator_deployment("o", "i", "m", ["u"]) == \
        jserving.render_operator_deployment("o", "i", "m", ["u"])
    with pytest.raises(ValueError):
        serving.render_serving_deployment("s", spec, "p", "i", "m",
                                          pool="other")
    with pytest.raises(ValueError):
        serving.render_router_deployment("r", "i", [])


def test_router_deployment_twins_the_reference():
    urls, dec = ["http://a:8000", "http://b:8000"], ["http://c:8000"]
    got = serving.render_router_deployment("r", "i", urls, decode_urls=dec)
    differ = assert_twins(got, jserving.render_router_deployment(
        "r", "i", urls, decode_urls=dec))
    assert differ == ["spec > template > spec > containers > router > "
                      "command"]


def test_serve_and_route_commands_parse_with_the_entry_points():
    """The rendered commands are argv the port's entry points accept."""
    from triton_kubernetes_tpu_torch.tools import route, serve

    cmd = serving.default_serve_command("llama3-8b", pool="decode")
    assert cmd[:3] == ["python", "-m",
                       "triton_kubernetes_tpu_torch.tools.serve"]
    a = serve._parser().parse_args(cmd[3:])
    assert (a.model, a.serve_host, a.port, a.pool) == (
        "llama3-8b", "0.0.0.0", 8000, "decode")
    cmd = serving.default_route_command(["http://a:8000"],
                                        decode_urls=["http://b:8000"])
    assert cmd[:3] == ["python", "-m",
                       "triton_kubernetes_tpu_torch.tools.route"]
    a = route._parser().parse_args(cmd[3:])
    assert (a.replicas, a.decode_replicas, a.route_host, a.port) == (
        ["http://a:8000"], ["http://b:8000"], "0.0.0.0", 8001)
    ref = jserving.default_route_command(["http://a:8000"],
                                         decode_urls=["http://b:8000"])
    assert cmd[3:] == ref[2:]
    assert serving.default_serve_command("m")[3:] == \
        jserving.default_serve_command("m")[2:]


# ---------------------------------------------------------- __main__.py
def _render(*argv):
    out = subprocess.run(
        [sys.executable, "-m", "triton_kubernetes_tpu_torch.topology",
         *argv], cwd=ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout)


def test_render_cli_daemonsets_prints_a_list():
    got = _render("daemonsets", "--accelerator", "h100-8", "--image", "im")
    assert got["kind"] == "List"
    spec = GpuPoolSpec.from_accelerator("h100-8")
    assert got["items"] == [ds.render_gpu_runtime_daemonset(spec, "im"),
                            ds.render_gpu_device_plugin(spec),
                            ds.render_gpu_health_daemonset(spec, "im")]


def test_render_cli_jobset_prints_a_list():
    got = _render("jobset", "--name", "t", "--accelerator", "h100-16",
                  "--slice-id", "c-p", "--env", "A=1", "--command",
                  "python", "-m", "x", "--resume")
    spec = GpuPoolSpec.from_accelerator("h100-16")
    assert got == {"apiVersion": "v1", "kind": "List", "items": [
        js.render_headless_service("t"),
        js.render_jobset("t", spec, "c-p", ds.DEFAULT_RUNTIME_IMAGE,
                         ["python", "-m", "x", "--resume"],
                         env={"A": "1"})]}
    default = _render("jobset", "--name", "t", "--accelerator", "h100-8",
                      "--slice-id", "c-p")
    assert default["items"][1]["spec"]["template"]["spec"]["containers"][
        0]["command"] == js.HOST_LAUNCH + js.DEFAULT_TRAIN_COMMAND


def test_render_cli_refuses_a_bad_accelerator():
    out = subprocess.run(
        [sys.executable, "-m", "triton_kubernetes_tpu_torch.topology",
         "daemonsets", "--accelerator", "h100-3"], cwd=ROOT,
        capture_output=True, text=True)
    assert out.returncode == 2 and "h100-3" in out.stderr


def test_rendering_imports_neither_torch_nor_jax():
    code = ("import sys, triton_kubernetes_tpu_torch.topology.__main__, "
            "triton_kubernetes_tpu_torch.modules.gcp_gpu, "
            "triton_kubernetes_tpu_torch.workflows.providers.gcp_gpu; "
            "bad = [m for m in sys.modules if m in ('torch', 'jax') or "
            "m.startswith('triton_kubernetes_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


# ---------------------------------------------------- modules/gcp_gpu.py
@pytest.fixture()
def reference_pool(tmp_path):
    """The reference's gcp-tpu-k8s + gcp-tpu-nodepool (v5e-8) + tpu-jobset
    applied on its simulated cloud: (outputs of the pool, of the job, the
    DaemonSets, the Job and Service manifests)."""
    d = StateDocument("mgr")
    d.set_backend_config({"local": {"path": str(tmp_path / "tf.tfstate")}})
    d.set_manager({"source": "modules/aws-manager", "name": "mgr",
                   "aws_access_key": "ak", "aws_secret_key": "sk"})
    creds = {"gcp_path_to_credentials": "/tmp/creds.json",
             "gcp_project_id": "proj"}
    ckey = d.add_cluster("gcp-tpu", "ml", {
        "source": "modules/gcp-tpu-k8s", "name": "ml",
        "manager_url": "${module.cluster-manager.manager_url}",
        "manager_access_key": "${module.cluster-manager.manager_access_key}",
        "manager_secret_key": "${module.cluster-manager.manager_secret_key}",
        **creds})
    d.add_node(ckey, "pool0", {
        "source": "modules/gcp-tpu-nodepool", "pool_name": "pool0",
        "gke_cluster_name": "ml", "cluster_id": f"${{module.{ckey}.cluster_id}}",
        **creds, "tpu_accelerator": "v5e-8"})
    pool_key = "node_gcp-tpu_ml_pool0"
    d.set("module.job_train", {
        "source": "modules/tpu-jobset", "job_name": "train",
        "cluster_id": f"${{module.{ckey}.cluster_id}}",
        "tpu_accelerator": "v5e-8",
        "slice_id": f"${{module.{pool_key}.slice_id}}",
        "image": "img", "command": ["python", "-m", "x"]})
    ex = LocalExecutor(log=lambda m: None)
    ex.apply(d)
    cloud = ex.cloud_view(d)
    cluster_id = ex.output(d, ckey)["cluster_id"]
    yield dict(pool=ex.output(d, pool_key), job=ex.output(d, "job_train"),
               cluster_id=cluster_id,
               daemonsets=cloud.get_manifests(cluster_id, "DaemonSet"),
               jobs=cloud.get_manifests(cluster_id, "Job"),
               services=cloud.get_manifests(cluster_id, "Service"))
    delete_executor_state(d)


def test_nodepool_module_twins_the_references(reference_pool):
    ref = reference_pool
    got = gcp_gpu.render_gpu_nodepool({
        "pool_name": "pool0", "gke_cluster_name": "ml",
        "cluster_id": ref["cluster_id"],
        "gcp_path_to_credentials": "/tmp/creds.json",
        "gcp_project_id": "proj", "gpu_accelerator": "h100-8"})
    want = {k: v for k, v in ref["pool"].items() if k != "topology"}
    assert_twins(got["outputs"], want)
    assert sorted(ref["pool"]) == sorted(
        ["topology"] + [_KEY_TWINS.get(k, k)
                        for k in gcp_gpu.NODEPOOL_OUTPUTS])
    assert len(got["manifests"]) == len(ref["daemonsets"]) == 3

    def role(m):
        name = m["metadata"]["name"]
        return [r for r in ("runtime", "plugin", "health")
                if r in name][0]

    theirs = {role(m): m for m in ref["daemonsets"]}
    for g in got["manifests"]:
        assert_twins(g, theirs[role(g)])
    node = got["terraform"]["resource"]["google_container_node_pool"]["gpu"]
    assert node["node_count"] == 1
    assert node["node_config"][0]["guest_accelerator"][0] == {
        "type": "nvidia-h100-80gb", "count": 8,
        "gpu_driver_installation_config": [
            {"gpu_driver_version": "LATEST"}]}
    assert node["placement_policy"] == [{"type": "COMPACT"}]
    assert got["node_labels"] == labels.host_labels_for_pool(
        GpuPoolSpec.from_accelerator("h100-8"), "ml-pool0")
    with pytest.raises(ValueError, match="gpu_accelerator"):
        gcp_gpu.render_gpu_nodepool({"pool_name": "p"})


def test_nodepool_resource_has_the_hcl_twins_keys():
    """The Python render and the HCL module create the same node pool
    resource, field for field."""
    got = gcp_gpu.render_gpu_nodepool({
        "pool_name": "p", "gke_cluster_name": "c", "cluster_id": "i",
        "gcp_path_to_credentials": "/c", "gcp_project_id": "pr",
        "gpu_accelerator": "h100-16", "reserved": True})
    node = got["terraform"]["resource"]["google_container_node_pool"]["gpu"]
    hcl = json.loads((TF / "gcp-gpu-nodepool" / "main.tf.json").read_text())[
        "resource"]["google_container_node_pool"]["gpu"]

    def keys(x, path=()):
        if isinstance(x, dict):
            return {p for k, v in x.items() if k != "//"
                    for p in keys(v, path + (k,))} | {path}
        if isinstance(x, list) and x and isinstance(x[0], dict):
            return keys(x[0], path)
        return {path}

    assert keys(node) == keys(hcl)
    assert node["node_count"] == 2
    assert node["node_config"][0]["machine_type"] == "a3-highgpu-8g"
    assert node["node_config"][0]["reservation_affinity"] == [
        {"consume_reservation_type": "ANY_RESERVATION"}]
    assert got["outputs"]["node_names"] == ["c-p-0", "c-p-1"]


def test_jobset_module_twins_the_references(reference_pool):
    ref = reference_pool
    got = gcp_gpu.render_gpu_jobset({
        "job_name": "train", "cluster_id": ref["cluster_id"],
        "gpu_accelerator": "h100-8", "slice_id": ref["pool"]["slice_id"],
        "image": "img", "command": ["python", "-m", "x"]})
    assert_twins(got["outputs"], ref["job"])
    svc, job = got["manifests"]
    assert_twins(svc, ref["services"][0])
    assert_twins(job, ref["jobs"][0])
    assert gcp_gpu.jobset_container(got)["command"] == js.HOST_LAUNCH + [
        "python", "-m", "x"]
    default = gcp_gpu.render_gpu_jobset({
        "job_name": "t", "cluster_id": "c", "gpu_accelerator": "h100-8",
        "slice_id": "s"})
    assert gcp_gpu.jobset_container(default)["command"] == \
        js.HOST_LAUNCH + js.DEFAULT_TRAIN_COMMAND


# ------------------------------------------ workflows/providers/gcp_gpu
def _reference_ctx(values):
    cfg = Config()
    for k, v in values.items():
        cfg.set(k, v)
    return WorkflowContext(backend=None, executor=None,
                           resolver=InputResolver(cfg, None, True))


def test_workflow_configs_twin_the_references():
    creds = {"gcp_path_to_credentials": "/c.json", "gcp_project_id": "pr"}
    state = StateDocument("mgr")
    ctx = _reference_ctx({**creds, "gcp_region": "us-east5",
                          "k8s_version": "1.31", "system_node_count": 1,
                          "tpu_accelerator": "v5e-8", "tpu_topology": "2x4",
                          "tpu_reserved": False, "tpu_spot": True})
    ckey = gcp_tpu.cluster_config(ctx, state, "ml")
    ref_cluster = state.get(f"module.{ckey}")
    got = wf.cluster_config("ml", **creds)
    assert {k: v for k, v in got.items() if k != "source"} == {
        k: v for k, v in ref_cluster.items() if k != "source"}
    assert got["source"] == "modules/gcp-gpu-k8s"

    pkey = gcp_tpu.node_config(ctx, state, ckey, "pool0")
    ref_pool = state.get(f"module.{pkey}")
    pool = wf.node_config(ckey, "pool0", "h100-8", **creds, spot=True)
    assert_twins(pool, {k: v for k, v in ref_pool.items()
                        if k != "tpu_topology"},
                 ACCELERATOR_PATHS + ("source", "tpu_accelerator"))
    assert pool["source"] == "modules/gcp-gpu-nodepool"
    with pytest.raises(ValueError):
        wf.node_config(ckey, "pool0", "h100-12", **creds)

    jctx = _reference_ctx({"job_image": "img",
                           "job_command": ["python", "-m", "x"],
                           "job_env": {}})
    jkey = gcp_tpu.jobset_config(jctx, state, ckey, pkey, "train")
    ref_job = state.get(f"module.{jkey}")
    job = wf.jobset_config(ckey, pkey, pool, "train", image="img",
                           command=["python", "-m", "x"])
    assert_twins(job, {k: v for k, v in ref_job.items()
                       if k != "tpu_topology"},
                 ACCELERATOR_PATHS + ("source", "tpu_accelerator"))
    assert wf.jobset_config(ckey, pkey, pool, "t")["command"] == \
        js.DEFAULT_TRAIN_COMMAND
    assert wf.parse_cluster_key("cluster_gcp-gpu_my_ml") == (
        "gcp-gpu", "my_ml")
    with pytest.raises(ValueError):
        wf.parse_cluster_key("node_x")


# ------------------------------------------------------------ HCL twins
HCL_TWINS = [("gcp-gpu-nodepool", "gcp-tpu-nodepool"),
             ("gpu-jobset", "tpu-jobset"), ("gcp-gpu-k8s", "gcp-tpu-k8s")]
# The HCL modules' accelerator variables and outputs.
HCL_ACCELERATOR_NAMES = {"tpu_accelerator", "tpu_topology", "topology",
                         "gpu_accelerator", "num_chips", "num_gpus"}


@pytest.mark.parametrize("gpu,tpu", HCL_TWINS)
def test_hcl_twins_parse_and_mirror_the_references(gpu, tpu):
    assert validate_module_dir(str(TF / gpu)) == []
    for fname in ("main.tf.json", "variables.tf.json", "outputs.tf.json"):
        json.loads((TF / gpu / fname).read_text())
    for fname, block in (("variables.tf.json", "variable"),
                         ("outputs.tf.json", "output")):
        mine = json.loads((TF / gpu / fname).read_text())[block]
        ref = json.loads((TF / tpu / fname).read_text())[block]
        assert set(mine) - HCL_ACCELERATOR_NAMES == \
            set(ref) - HCL_ACCELERATOR_NAMES, fname
        for k in set(mine) - HCL_ACCELERATOR_NAMES:
            if k not in ("image", "command", "system_node_count",
                         "runtime_image", "auto_repair"):
                assert mine[k] == ref[k], (fname, k)


def test_hcl_nodepool_twin_swaps_tpu_topology_for_guest_accelerator():
    mine = json.loads((TF / "gcp-gpu-nodepool" / "main.tf.json").read_text())
    ref = json.loads((TF / "gcp-tpu-nodepool" / "main.tf.json").read_text())
    allowed = ACCELERATOR_PATHS + (
        "//", "* > //", "locals > *", "* > node_count",
        "* > placement_policy > 0 > tpu_topology",
        "* > node_config > 0 > guest_accelerator",
        "* > node_config > 0 > machine_type",
        "* > triggers > accelerator", "* > triggers > pool",
        "* > local-exec > environment > TPU_*",
        "* > local-exec > environment > GPU_ACCELERATOR")
    differ = assert_twins(mine, ref, allowed)
    assert any(p.endswith("guest_accelerator") for p in differ)
    assert mine["provider"] == ref["provider"]
    assert mine["terraform"] == ref["terraform"]
    for sh in ("apply_daemonsets.sh",):
        text = (TF / "gcp-gpu-nodepool" / "files" / sh).read_text()
        assert "python -m triton_kubernetes_tpu_torch.topology" in text


def test_hcl_jobset_and_k8s_twins():
    mine = json.loads((TF / "gpu-jobset" / "main.tf.json").read_text())
    ref = json.loads((TF / "tpu-jobset" / "main.tf.json").read_text())
    allowed = ("//", "locals > gpus", "locals > chips", "locals > num_hosts",
               "* > local-exec > environment > TPU_*",
               "* > local-exec > environment > GPU_ACCELERATOR")
    assert_twins(mine, ref, allowed)
    text = (TF / "gpu-jobset" / "files" / "apply_jobset.sh").read_text()
    assert "python -m triton_kubernetes_tpu_torch.topology" in text
    variables = json.loads((TF / "gpu-jobset" / "variables.tf.json")
                           .read_text())["variable"]
    assert variables["command"]["default"] == js.DEFAULT_TRAIN_COMMAND
    mine = json.loads((TF / "gcp-gpu-k8s" / "main.tf.json").read_text())
    ref = json.loads((TF / "gcp-tpu-k8s" / "main.tf.json").read_text())
    differ = assert_twins(mine, ref, ("//", "* > allow > 0 > ports",
                                      "* > query > kind"))
    assert mine["data"]["external"]["cluster_registration"]["query"][
        "kind"] == "gke-gpu"
    assert len(differ) == 3


# --------------------------------------------------------- image configs
@pytest.mark.parametrize("gpu,tpu", [
    ("torch-cuda-runtime.yaml", "jax-tpu-runtime.yaml"),
    ("gpu-health-probe.yaml", "tpu-health-probe.yaml")])
def test_image_configs_load_through_the_reference_pipeline(gpu, tpu):
    mine = load_template(str(IMAGES / gpu))
    ref = load_template(str(IMAGES / tpu))
    assert sorted(mine) == sorted(ref)
    assert "{{" not in json.dumps(mine)
    assert mine["image"].startswith("tk8s/")


def test_runtime_image_carries_nvcc_and_runs_the_port():
    cfg = load_template(str(IMAGES / "torch-cuda-runtime.yaml"))
    assert "-devel-" in cfg["base"]  # the CUDA toolkit, nvcc included
    assert cfg["entrypoint"] == js.DEFAULT_TRAIN_COMMAND
    assert any(p.startswith("torch==") for p in cfg["pip"])
    assert cfg["image"] + ":0.1.0" == ds.DEFAULT_RUNTIME_IMAGE
