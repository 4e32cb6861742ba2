"""The last public symbols of the JAX package that the port lacked, held
against the JAX ones on the CPU: ``NoEncoder``, ``SwishGLUDense`` (f32,
on the same numpy parameters, with and without bias) and the helpers of
``utils/utils.py`` (``get_portion_of_batch_ids``, ``format_sftp_path``,
``timeit`` and, where OpenCV is installed, ``add_text_overlay``, bit for
bit). ``ResNetTokenEncoderWithFiLM`` is a case of
``test_torch_resnet.py::test_other_encoders_match_jax``."""
import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.encoders import resnet as jres
from mode_diffusion_policy_tpu.ops import primitives as jprim
from mode_diffusion_policy_tpu.utils import utils as jutils
from mode_diffusion_policy_tpu_torch.models.encoders import resnet as tres
from mode_diffusion_policy_tpu_torch.ops import primitives as tprim
from mode_diffusion_policy_tpu_torch.utils import utils as tutils
from mode_diffusion_policy_tpu_torch.utils.weights import port_tree
from torch_threads import two_torch_threads  # noqa: F401


def test_no_encoder_returns_its_input():
    x = torch.randn(2, 3, 8, 8, 3)
    enc = tres.NoEncoder()
    assert enc(x) is x
    assert enc(x, torch.randn(2, 4), train=True) is x
    assert list(enc.parameters()) == []
    xj = jnp.ones((2, 3))
    assert jres.NoEncoder().apply({}, xj, None, train=True) is xj


def test_token_encoder_defaults_like_jax():
    """The token encoder is the scratch ResNet-18 with a 128-wide head by
    default, as JAX's."""
    assert jres.ResNetTokenEncoderWithFiLM(16).latent_dim == 128
    enc = tres.ResNetTokenEncoderWithFiLM(16, device="meta")
    assert isinstance(enc, tres.ResNetEncoderWithFiLM)
    assert enc.latent_dim == 128 and enc.fc.kernel.shape == (512, 128)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_swishglu_dense_matches_jax(use_bias, in_dtype):
    """The same numpy parameters through both modules (a bf16 input is
    promoted to the f32 parameters on both sides), within 2e-5."""
    r = np.random.default_rng(3)
    din, dout = 48, 40
    params = {"project": {"kernel": (r.standard_normal((din, 2 * dout))
                                     / np.sqrt(din)).astype(np.float32)}}
    if use_bias:
        params["project"]["bias"] = (0.1 * r.standard_normal(2 * dout)
                                     ).astype(np.float32)
    x = r.standard_normal((3, 5, din)).astype(np.float32)
    want = np.asarray(jprim.SwishGLUDense(dout, use_bias=use_bias).apply(
        {"params": params}, jnp.asarray(x, in_dtype)))
    mod = tprim.SwishGLUDense(din, dout, use_bias=use_bias, device="cpu")
    mod.load_state_dict(port_tree(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(getattr(torch, in_dtype)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert [n for n, _ in mod.named_parameters()] == (
        ["project.kernel", "project.bias"] if use_bias
        else ["project.kernel"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("percentage,batch_size",
                         [(0.0, 8), (0.25, 8), (0.5, 128), (1.0, 5)])
def test_portion_of_batch_ids_match(percentage, batch_size):
    got = tutils.get_portion_of_batch_ids(percentage, batch_size)
    want = jutils.get_portion_of_batch_ids(percentage, batch_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(got) == int(batch_size * percentage)


@pytest.mark.parametrize("path", ["sftp://host/a/b", "/data/calvin/x",
                                  Path("relative/dir")])
def test_format_sftp_path_matches(path):
    got = tutils.format_sftp_path(path)
    assert isinstance(got, Path)
    assert got == jutils.format_sftp_path(path)


def _payload(a, b=2):
    """A function to time."""
    return a * b


def test_timeit_matches(caplog):
    """Same return value, same wrapped name and docstring, and one DEBUG
    record on the function's module logger with the same message."""
    records = []
    for mod in (tutils, jutils):
        fn = mod.timeit(_payload)
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger=__name__):
            assert fn(3, b=4) == 12
        assert fn.__name__ == "_payload" and fn.__wrapped__ is _payload
        assert fn.__doc__ == _payload.__doc__
        (rec,) = [r for r in caplog.records if r.name == __name__]
        records.append((rec.levelno, rec.msg, rec.args[0]))
        assert rec.getMessage().startswith("_payload took ")
        assert rec.getMessage().endswith("s")
    assert records[0] == records[1] == (logging.DEBUG, "%s took %.3fs",
                                        "_payload")


@pytest.mark.parametrize("hw", [(64, 96), (600, 320)])
def test_add_text_overlay_bit_equal(hw):
    pytest.importorskip("cv2")
    r = np.random.default_rng(5)
    img = r.integers(0, 256, hw + (3,), dtype=np.uint8)
    got = tutils.add_text_overlay(img.copy(), "open the drawer")
    want = jutils.add_text_overlay(img.copy(), "open the drawer")
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert not np.array_equal(got, img)
    np.testing.assert_array_equal(got, want)
    got = tutils.add_text_overlay(img[::2], "lift", color=(0, 255, 0))
    np.testing.assert_array_equal(
        got, jutils.add_text_overlay(img[::2], "lift", color=(0, 255, 0)))


def test_bench_data_prints_bench_data_keys(monkeypatch, capsys):
    """``bench_data_torch.main`` at 2 batches of 16-px frames, inline
    assembly and the shm cache, prints one JSON line with
    ``bench_data.py``'s keys less ``vs_train_step`` (a TPU step's rate) and
    leaves no shared-memory segment behind."""
    import json
    import os

    import bench_data
    import bench_data_torch
    env = {"BENCH_DATA_BATCHES": "2", "BENCH_DATA_HW": "16",
           "BENCH_DATA_WORKERS": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # the JAX tool leaves its shm cache open: run it without one
    monkeypatch.setenv("BENCH_DATA_SHM", "0")
    bench_data.main([])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.delenv("BENCH_DATA_SHM")
    shm_before = set(os.listdir("/dev/shm"))
    got = bench_data_torch.main([])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == got
    assert set(got) == set(want) - {"vs_train_step"}
    assert got["batch"] == 32 and got["workers"] == 0
    assert got["shm_cache"] is True and got["value"] > 0
    assert not {f for f in set(os.listdir("/dev/shm")) - shm_before
                if f.startswith("mode_torch_")}
