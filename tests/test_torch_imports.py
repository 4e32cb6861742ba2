"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points refuse to run without CUDA unless asked for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mode_diffusion_policy_tpu_torch import resolve_device
from mode_diffusion_policy_tpu_torch.models.agent import (MoDEAgent,
                                                          MoDEAgentConfig,
                                                          RolloutPolicy)
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_layer_q8c)
from mode_diffusion_policy_tpu_torch.serving import (PRESET_FLAGS,
                                                     SERVING_MODES,
                                                     preset_flags,
                                                     resolve_serving_mode)
from mode_diffusion_policy_tpu_torch.training.loop import (Trainer,
                                                           make_train_step)
from mode_diffusion_policy_tpu_torch.training.optim import make_optimizer
from torch_threads import THREADS, two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mode_diffusion_policy_tpu_torch"
BANNED = ("jax", "flax", "optax", "orbax", "chex", "mode_diffusion_policy_tpu")

TINY = dict(latent_dim=128, n_layers=1, n_heads=1, cond_dim=16,
            num_experts=4, top_k=2)


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_kernels_torch.py",
    ROOT / "bench_data_torch.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path} imports {bad}"


# optional packages the card's machine may lack: every port module imports
# without them (each is imported only where a branch needs it)
OPTIONAL = ("yaml", "regex", "cv2", "wandb", "safetensors", "h5py",
            "matplotlib")


def test_port_imports_with_jax_blocked():
    """Import every port module (the data and LIBERO slices, both
    training CLIs and the auxiliary modules named), chip_smoke.py's module-level code,
    bench_kernels_torch.py and bench_data_torch.py with jax, the JAX
    package and the optional packages (``yaml``, ``h5py``, ``cv2`` ...)
    made unimportable."""
    code = f"""
import importlib, pkgutil, sys
for name in {BANNED + OPTIONAL!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
import mode_diffusion_policy_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
# the data and LIBERO slices and the training CLIs are among them (so the
# LIBERO datasets import without h5py), and the datasets' statistics merge
# needs no PyYAML while a split has no statistics.yaml
new = set("mode_diffusion_policy_tpu_torch." + m for m in (
    "training_calvin", "data.calvin_dataset", "data.datamodule",
    "data.episode_utils", "data.preprocess", "data.shm_cache",
    "data.libero", "rollout.libero_rollout", "rollout.rollout_single_task",
    "evaluation.evaluate_libero", "evaluation.determinism_check",
    "training_libero", "training_common", "config.builders",
    "models.encoders.clip_visual", "models.encoders.lang_cache",
    "utils.export", "utils.torch_oracles", "utils.verify_checkpoint",
    "utils.lang_annotators", "utils.hashing", "parallel.mesh",
    "parallel.collectives"))
assert new <= set(names), new - set(names)
from mode_diffusion_policy_tpu_torch.data.episode_utils import (
    load_dataset_statistics)
t = {{"train": {{}}, "val": {{}}}}
assert load_dataset_statistics("/nonexistent/a", "/nonexistent/b", t) is t
import runpy
runpy.run_path({str(ROOT / "chip_smoke.py")!r}, run_name="chip_smoke_import")
runpy.run_path({str(ROOT / "bench_kernels_torch.py")!r},
               run_name="bench_kernels_torch_import")
runpy.run_path({str(ROOT / "bench_data_torch.py")!r},
               run_name="bench_data_torch_import")
# the closing slice's symbols import without cv2
from mode_diffusion_policy_tpu_torch.models.encoders.resnet import (
    NoEncoder, ResNetTokenEncoderWithFiLM)
from mode_diffusion_policy_tpu_torch.ops.primitives import SwishGLUDense
from mode_diffusion_policy_tpu_torch.utils.utils import (
    add_text_overlay, format_sftp_path, get_portion_of_batch_ids, timeit)
# importing builds and loads no kernel: that happens at the first CUDA call
from mode_diffusion_policy_tpu_torch.ops.kernels import (
    _build, attn_kernel, layer_kernel, moe_kernel)
assert _build.load_library.cache_info().currsize == 0
assert layer_kernel.fused_dit_q8c.launches == 0
assert attn_kernel.fused_attn_block_q8.launches == 0
assert attn_kernel.fused_attn_block.launches == 0
assert moe_kernel.fused_top2_mlp_q8c.launches == 0
assert moe_kernel.fused_top2_mlp.launches == 0
assert moe_kernel.fused_top2_mlp_q8.launches == 0
# nor the C hashers: they are built at the first construction of one
from mode_diffusion_policy_tpu_torch.utils import hashing
assert hashing._native is None
from mode_diffusion_policy_tpu_torch.models.edm import log_likelihood
from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import (
    VLMEmbeddingCache)
print(len(names), "modules")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without CUDA the smoke run exits non-zero and prints no result."""
    code = (f"import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['chip_smoke.py']; import runpy; "
            f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, "
            f"run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_bench_skips_without_cuda(monkeypatch, capsys):
    """Without CUDA the kernel bench prints one skip line and returns; an
    unknown bench name is refused."""
    import bench_kernels_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench_kernels_torch.main(["moe", "layer"])
    assert capsys.readouterr().out.strip().splitlines() == [
        '{"skipped": "CUDA is not available"}']
    with pytest.raises(SystemExit, match="unknown bench"):
        bench_kernels_torch.main(["warp"])


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoDEAgent(MoDEAgentConfig(**TINY))
    assert resolve_device("cpu") == torch.device("cpu")
    agent = MoDEAgent(MoDEAgentConfig(**TINY), device="cpu")
    assert next(agent.parameters()).device.type == "cpu"
    # the training entry points: CUDA by default, the CPU when asked
    opt, _ = make_optimizer(dict(agent.named_parameters()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(agent, log_dir=str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(agent, opt)
    assert Trainer(agent, log_dir=str(tmp_path / "run"),
                   device="cpu").device.type == "cpu"
    assert callable(make_train_step(agent, opt, device="cpu"))


def test_init_distributed_refuses_two_ranks_on_one_card(monkeypatch):
    """NCCL takes one card per rank: with a stub of one card and two local
    ranks in torchrun's variables, ``init_distributed`` raises before it
    starts a group (gloo, named, may share the card). Without torchrun's
    variables it raises too: no silent world of 1."""
    from mode_diffusion_policy_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL would put 2 ranks on 1"):
        mesh.init_distributed()
    with pytest.raises(RuntimeError, match="NCCL would put 2 ranks on 1"):
        mesh.init_distributed("nccl")
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is not set"):
        mesh.init_distributed("gloo", device="cpu")


def test_distributed_entry_points_need_cuda_or_explicit_cpu(monkeypatch,
                                                            tmp_path):
    """Without CUDA, ``init_distributed()`` and ``make_mesh()`` under a
    live process group raise unless the caller names ``device="cpu"``:
    no silent fall back to gloo on the CPU."""
    import torch.distributed as dist
    from mode_diffusion_policy_tpu_torch.parallel import mesh
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.make_mesh()
        world = mesh.make_mesh("cpu")
        assert (world.size, world.device.type) == (1, "cpu")
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_distributed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_distributed("gloo")
    assert not dist.is_initialized()


def test_serving_mode_names():
    assert set(PRESET_FLAGS) | {"auto"} == set(SERVING_MODES)
    assert set(PRESET_FLAGS) == {"reference", "parity", "max-throughput",
                                 "b1-latency", "b1-latency-max"}
    # every preset is ported: the flags at the flagship config
    assert all(PRESET_FLAGS[m] == preset_flags(MoDEAgentConfig(), m)
               for m in PRESET_FLAGS)
    assert resolve_serving_mode("auto", "cuda") == "parity"
    assert resolve_serving_mode("auto", "cpu") == "reference"
    with pytest.raises(ValueError, match="unknown serving mode"):
        resolve_serving_mode("warp-speed")


def test_megakernel_presets_run_on_the_cpu_when_asked():
    """b1-latency and b1-latency-max are ported: on a CPU agent they build
    the layer stack and run the plain version of the megakernel."""
    for mode in ("b1-latency", "b1-latency-max"):
        agent = MoDEAgent(MoDEAgentConfig(**TINY), device="cpu")
        policy = RolloutPolicy.with_serving_mode(agent, mode=mode)
        assert agent.cfg.use_megakernel
        assert agent.cfg.use_int8_attn == (mode == "b1-latency-max")
        assert agent.inner_model.stacked["w1_q"].shape[0] == TINY["n_layers"]
        obs = {k: torch.zeros(1, 1, 32, 32, 3) for k in ("rgb_static",
                                                         "rgb_gripper")}
        chunk = policy.predict_chunk(
            obs, {"lang_emb": torch.zeros(1, 1, TINY["cond_dim"])})
        assert chunk.shape == (1, 10, 7) and torch.isfinite(chunk).all()


def test_max_throughput_runs_on_the_cpu_when_asked():
    """max-throughput is ported: on a CPU agent it builds the int8
    encoders (dynamic scales without a calibration batch) and runs the
    plain versions of the attention and MoE kernels."""
    agent = MoDEAgent(MoDEAgentConfig(**TINY), device="cpu")
    policy = RolloutPolicy.with_serving_mode(agent, mode="max-throughput")
    cfg = policy.agent.cfg
    assert cfg.use_int8_attn and cfg.use_int8_moe and not cfg.use_fused_layer
    assert policy.agent.q8 is not None and not policy.agent.q8_clips
    obs = {k: torch.rand(2, 1, 32, 32, 3) for k in ("rgb_static",
                                                    "rgb_gripper")}
    chunk = policy.predict_chunk(
        obs, {"lang_emb": torch.zeros(2, 1, TINY["cond_dim"])})
    assert chunk.shape == (2, 10, 7) and torch.isfinite(chunk).all()


def test_layer_wrapper_rejects_other_devices():
    x = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_layer_q8c(x, *([None] * 11))


@pytest.mark.parametrize("names", [["attn_proj"], ["attn_core"],
                                   ["encoder"], []])
def test_closing_benches_skip_without_cuda(monkeypatch, capsys, names):
    """The attention products', the attention core's and the encoders'
    benches, and all benches (no name), print the one skip line without
    CUDA; the three are among the bench's names."""
    import bench_kernels_torch
    assert {"attn_proj", "attn_core", "encoder"} <= set(
        bench_kernels_torch.ALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench_kernels_torch.main(names)
    assert capsys.readouterr().out.strip().splitlines() == [
        '{"skipped": "CUDA is not available"}']


def test_every_port_test_file_caps_torch_threads():
    """Each ``tests/test_torch_*.py`` imports the shared thread cap,
    ``torch_threads.two_torch_threads``, at its top level; in this module
    it holds torch and the environment that a child process inherits at
    the cap."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 30
    missing = []
    for path in files:
        body = ast.parse(path.read_text()).body
        if not any(isinstance(n, ast.ImportFrom)
                   and n.module == "torch_threads"
                   and "two_torch_threads" in [a.name for a in n.names]
                   for n in body):
            missing.append(path.name)
    assert not missing, f"without the shared thread cap: {missing}"
    assert torch.get_num_threads() <= THREADS
    assert int(os.environ["OMP_NUM_THREADS"]) <= THREADS
