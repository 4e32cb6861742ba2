"""The port's language path against the JAX package's: the BPE tokenizer
(stdlib ``re`` with character classes from ``unicodedata``, against the
JAX tokenizer's ``regex``), the CLIP text tower in f32 on the same weights
(``utils/weights.from_jax_clip_text``), the OpenAI-state-dict converter,
and the language-embedding cache."""
import pathlib
import re
import unicodedata

import jax
import numpy as np
import pytest
import regex
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from mode_diffusion_policy_tpu.models.encoders import clip_text as jclip
from mode_diffusion_policy_tpu.models.encoders import lang_cache as jcache
from mode_diffusion_policy_tpu.models.encoders import tokenizer as jtok
from mode_diffusion_policy_tpu_torch.models.encoders import clip_text as tclip
from mode_diffusion_policy_tpu_torch.models.encoders import lang_cache as tcache
from mode_diffusion_policy_tpu_torch.models.encoders import tokenizer as ttok
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_clip_text
from torch_threads import two_torch_threads  # noqa: F401

CONF = pathlib.Path(__file__).resolve().parents[1] / "conf"
TINY = dict(width=64, heads=4, layers=2, embed_dim=32)
TEXTS = ["push the red block to the right", "open the drawer",
         "turn on the led light", "Lift the pink block!",
         "pick up the blue block and place it in the slider"]


def _instructions():
    out = []
    for path in sorted((CONF / "annotations").glob("*.yaml")):
        for v in yaml.safe_load(path.read_text()).values():
            out.extend(v if isinstance(v, list) else [v])
    return out


def test_tokenizer_matches_on_every_instruction():
    texts = _instructions()
    assert len(texts) > 60
    np.testing.assert_array_equal(ttok.tokenize(texts), jtok.tokenize(texts))
    assert ttok.tokenize(texts).dtype == np.int32


@settings(max_examples=150, deadline=None)
@given(st.text(max_size=60))
def test_tokenizer_matches_on_any_text(text):
    """Token ids equal to the JAX tokenizer's (truncated to the context),
    except on code points that only one module's Unicode tables assign."""
    if any(unicodedata.category(c) == "Cn" for c in text):
        return
    tok_t, tok_j = ttok.CLIPTokenizer(), jtok.get_tokenizer()
    assert tok_t.encode(text) == tok_j.encode(text)
    np.testing.assert_array_equal(ttok.tokenize(text, truncate=True),
                                  jtok.tokenize(text, truncate=True))


def test_character_classes_match_regex():
    """Every code point up to U+FFFF, alone and inside text: the port's
    classes against ``regex``'s ``[\\p{L}]+``, ``[\\p{N}]``,
    ``[^\\s\\p{L}\\p{N}]+`` and ``\\s`` under its IGNORECASE. Every
    difference is a code point unassigned in the stdlib's Unicode tables
    (``unicodedata.unidata_version``) that ``regex``'s newer tables assign;
    the printout names them."""
    L, N, F = ttok.unicode_classes()
    ws = ttok._WHITESPACE
    pairs = [(regex.compile(r"[\p{L}]+", regex.I), re.compile(f"[{L}]+")),
             (regex.compile(r"[\p{N}]", regex.I), re.compile(f"[{N}]")),
             (regex.compile(r"[^\s\p{L}\p{N}]+", regex.I),
              re.compile(f"[^{ws}{L}{N}{F}]+")),
             (regex.compile(r"\s+"), re.compile(f"[{ws}]+"))]
    pat_j = jtok.get_tokenizer().pat
    pat_t = ttok.word_pattern()
    diff = set()
    for cp in range(0x10000):
        if 0xD800 <= cp < 0xE000:
            continue
        c = chr(cp)
        for a, b in pairs:
            if bool(a.fullmatch(c)) != bool(b.fullmatch(c)):
                diff.add(cp)
        s = f"a{c}b 1{c}2 ,{c}. 's{c}"
        if regex.findall(pat_j, s) != pat_t.findall(s):
            diff.add(cp)
    print(f"Unicode {unicodedata.unidata_version} (stdlib) vs regex "
          f"{regex.__version__}: {len(diff)} code points differ: "
          + " ".join(f"U+{cp:04X}" for cp in sorted(diff)))
    assert all(unicodedata.category(chr(cp)) == "Cn" for cp in diff)
    assert len(diff) < 100


@pytest.fixture(scope="module")
def towers():
    jlang = jclip.LangClip.initialize_random(
        jax.random.PRNGKey(0), jclip.CLIPTextConfig(**TINY))
    sd = from_jax_clip_text(jax.tree.map(np.asarray, jlang.params))
    tlang = tclip.LangClip.from_state_dict(
        sd, tclip.CLIPTextConfig(**TINY), device="cpu")
    return jlang, tlang


def test_lang_clip_matches_jax(towers):
    jlang, tlang = towers
    want = np.asarray(jlang(TEXTS))
    got = tlang(TEXTS)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.shape == want.shape == (len(TEXTS), 1, TINY["embed_dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert not any(p.requires_grad for p in tlang.model.parameters())


def _openai_state_dict(seed=0, width=64, layers=2, embed=32, ctx=77,
                       vocab=49408):
    r = np.random.default_rng(seed)

    def n(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                                * 0.05)

    sd = {"token_embedding.weight": n(vocab, width),
          "positional_embedding": n(ctx, width),
          "text_projection": n(width, embed),
          "ln_final.weight": 1 + n(width), "ln_final.bias": n(width),
          "logit_scale": torch.tensor(4.6),
          "visual.conv1.weight": n(8, 3, 2, 2)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        sd.update({
            p + "ln_1.weight": 1 + n(width), p + "ln_1.bias": n(width),
            p + "ln_2.weight": 1 + n(width), p + "ln_2.bias": n(width),
            p + "attn.in_proj_weight": n(3 * width, width),
            p + "attn.in_proj_bias": n(3 * width),
            p + "attn.out_proj.weight": n(width, width),
            p + "attn.out_proj.bias": n(width),
            p + "mlp.c_fc.weight": n(4 * width, width),
            p + "mlp.c_fc.bias": n(4 * width),
            p + "mlp.c_proj.weight": n(width, 4 * width),
            p + "mlp.c_proj.bias": n(width)})
    return sd


def test_convert_clip_text_matches_jax():
    """An OpenAI-layout state dict: the port's conversion equals JAX's
    conversion carried over by from_jax_clip_text, bit for bit, and the
    inferred configs agree."""
    sd = _openai_state_dict()
    got = tclip.convert_clip_text(sd)
    want = from_jax_clip_text(jclip.convert_clip_text(sd))
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    tcfg, jcfg = tclip.infer_text_config(sd), jclip.infer_text_config(sd)
    for f in ("vocab_size", "context_length", "width", "heads", "layers",
              "embed_dim"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.width, tcfg.heads, tcfg.layers) == (64, 1, 2)
    tower = tclip.LangClip.from_state_dict(got, tcfg, device="cpu")
    jtower = jclip.LangClip(jclip.convert_clip_text(sd), jcfg)
    np.testing.assert_allclose(tower(TEXTS[:2]).numpy(),
                               np.asarray(jtower(TEXTS[:2])), atol=2e-5)


def test_lang_cache_matches_jax(towers, tmp_path):
    jlang, tlang = towers
    calls = {"t": [], "j": []}

    def enc(fn, key):
        def wrapped(texts):
            calls[key].append(list(texts))
            return fn(texts)
        return wrapped

    tc = tcache.LangEmbeddingCache(enc(tlang, "t"), buffer_size=3)
    jc = jcache.LangEmbeddingCache(enc(jlang, "j"), buffer_size=3)
    assert tc.device == torch.device("cpu")
    for batch in (TEXTS[:2], TEXTS[:2], TEXTS[2:5], ["new", "new"],
                  TEXTS[:1]):
        got, want = tc(batch), jc(batch)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        assert len(tc) == len(jc) and list(tc._buf) == list(jc._buf)
    assert calls["t"] == calls["j"]
    assert tc.encoder_calls == len(calls["t"]) == 4
    assert tc.encoded_texts == sum(map(len, calls["t"]))
    # the saved files are one format: each package reads the other's
    tc.save(str(tmp_path / "t.pkl"))
    jc.save(str(tmp_path / "j.pkl"))

    def refuse(texts):
        raise AssertionError("a hit must not encode")

    t2 = tcache.LangEmbeddingCache(refuse, 10, device="cpu")
    t2.load(str(tmp_path / "j.pkl"))
    j2 = jcache.LangEmbeddingCache(refuse, 10)
    j2.load(str(tmp_path / "t.pkl"))
    keys = list(jc._buf)
    np.testing.assert_array_equal(t2(keys).numpy(), jc(keys))
    np.testing.assert_array_equal(j2(keys), tc(keys).numpy())


def test_clip_checkpoint_loader_matches_jax(tmp_path):
    """``--clip-checkpoint``: a synthetic OpenAI CLIP state dict in a
    ``.pt`` file, through both packages' ``build_lang_clip``."""
    from mode_diffusion_policy_tpu.config.builders import \
        build_lang_clip as jbuild
    from mode_diffusion_policy_tpu_torch.config.builders import \
        build_lang_clip as tbuild
    path = str(tmp_path / "clip.pt")
    torch.save(_openai_state_dict(seed=4), path)
    tower = tbuild(clip_checkpoint=path, device="cpu")
    assert tower.cfg.width == 64 and tower.device.type == "cpu"
    np.testing.assert_allclose(tower(TEXTS).numpy(),
                               np.asarray(jbuild(clip_checkpoint=path)(TEXTS)),
                               atol=2e-5, rtol=0)
