"""The port's CALVIN data layer against the JAX package's, on the synthetic
store of ``tests/calvin_fixture.py`` (3 episodes x 30 frames, 24 px): the
items of every dataset class, ``load_dataset_statistics``, the packed
actions of ``extract_by_key``, the validation window sizes, the
datamodule's train and val batches over two epochs at 0 and 2 workers,
with and without the shared-memory cache (bit for bit), loader failures
raised in the parent, the bounded worker queues, the stored goal
embeddings, and no shared-memory segment or lookup file left behind.

JAX's own datamodule runs inline without its cache here: its segment
names are fixed per split, and ``tests/test_data_calvin.py`` may use them
at the same moment in another worker. The port's segments take a tag per
test."""
import copy
import multiprocessing as mp
import os
import pathlib
import pickle
import time

import numpy as np
import pytest
import torch

from calvin_fixture import INSTRUCTIONS, make_calvin_dataset
from mode_diffusion_policy_tpu.data import calvin_dataset as jds
from mode_diffusion_policy_tpu.data import datamodule as jdm
from mode_diffusion_policy_tpu.data import episode_utils as jep
from mode_diffusion_policy_tpu.data import preprocess as jpre
from mode_diffusion_policy_tpu.data import shm_cache as jshm
from mode_diffusion_policy_tpu.evaluation import utils as jeval
from mode_diffusion_policy_tpu.utils import hashing as jhash
from mode_diffusion_policy_tpu_torch.data import calvin_dataset as tds
from mode_diffusion_policy_tpu_torch.data import datamodule as tdm
from mode_diffusion_policy_tpu_torch.data import episode_utils as tep
from mode_diffusion_policy_tpu_torch.data import preprocess as tpre
from mode_diffusion_policy_tpu_torch.data import shm_cache as tshm
from mode_diffusion_policy_tpu_torch.evaluation import utils as teval
from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
    LangEmbeddingCache
from mode_diffusion_policy_tpu_torch.utils import hashing as thash
from torch_threads import two_torch_threads  # noqa: F401

BATCH_KEYS = ("rgb_static", "rgb_gripper", "actions", "robot_obs", "idx",
              "lang_emb")
EXT = dict(key="lang", lang_folder="lang_annotations", min_window_size=10,
           max_window_size=10, pad=False, obs_seq_len=1, action_seq_len=10,
           future_range=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The fixture store with its packed actions (the port's extraction)."""
    r = make_calvin_dataset(tmp_path_factory.mktemp("calvin_torch"),
                            n_episodes=3, ep_len=30, hw=24)
    for split in ("training", "validation"):
        tpre.extract_by_key(r / split, "rel_actions", workers=2)
    return r


def fake_lang(texts):
    """A host embedder both packages call: the text's length and first
    character, 16 wide."""
    return np.stack([np.full((1, 16), len(t) + ord(t[0]) / 128, np.float32)
                     for t in texts])


def assert_same(a, b, where="item"):
    """Equal nested items: same keys, arrays equal in dtype, shape and
    bits, everything else equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _pair(cls_name, root, split="training", **kw):
    return (getattr(jds, cls_name)(root / split, **kw),
            getattr(tds, cls_name)(root / split, **kw))


@pytest.mark.parametrize("cls_name,kw", [
    ("DiskDataset", dict(key="lang", min_window_size=8, max_window_size=8,
                         pad=False)),
    ("DiskDataset", dict(key="lang", min_window_size=5, max_window_size=12,
                         pad=True, seed=3)),
    ("DiskDataset", dict(key="lang", min_window_size=5, max_window_size=12,
                         pad=True, window_sampling_strategy="geometric",
                         geometric_p_value=0.2, seed=1)),
    ("DiskDataset", dict(key="state", min_window_size=6, max_window_size=9,
                         pad=True, seed=2)),
    ("ExtendedDiskDataset", EXT),
    ("ExtendedDiskDataset", dict(EXT, use_extracted_rel_actions=True)),
    ("ExtendedDiskDataset", dict(EXT, obs_seq_len=2, action_seq_len=8,
                                 skip_frames=2)),
    ("SubsetDiskDataset", dict(EXT, subset_percentage=0.3)),
    ("LabeledSubsetDiskDataset", dict(EXT, subset_percentage=0.5)),
    ("BalancedLabeledSubsetDataset", dict(EXT, subset_percentage=0.5,
                                          min_samples_per_task=2)),
], ids=["disk", "disk-random-pad", "disk-geometric", "disk-nolang",
        "extended", "extended-packed", "extended-obs2-skip2", "subset",
        "labeled", "balanced"])
def test_dataset_items_match_jax(root, cls_name, kw):
    """Every item in order (training windows drawn from the same seeded
    numpy generator), and windows of a given size, equal JAX's."""
    jd, td = _pair(cls_name, root, **kw)
    assert len(jd) == len(td) > 0
    np.testing.assert_array_equal(jd.episode_lookup, td.episode_lookup)
    for i in range(len(td)):
        assert_same(jd[i], td[i], f"{cls_name}[{i}]")
    if kw.get("pad"):
        for i, w in ((0, 5), (7, 9)):
            assert_same(jd[(i, w)], td[(i, w)], f"{cls_name}[{i}, {w}]")


def test_validation_window_sizes_match_jax(root):
    """FNV-1 32 window sizes: the function, and a validation dataset's
    windows capped at the episode boundaries."""
    for lo, hi in ((5, 10), (1, 1), (16, 32), (3, 200)):
        for idx in range(300):
            assert (thash.get_validation_window_size(idx, lo, hi)
                    == jhash.get_validation_window_size(idx, lo, hi))
    kw = dict(key="lang", min_window_size=5, max_window_size=12, pad=True)
    jd, td = _pair("DiskDataset", root, "validation", **kw)
    sizes = [td._get_window_size(i) for i in range(len(td))]
    assert sizes == [jd._get_window_size(i) for i in range(len(jd))]
    assert len(set(sizes)) > 1
    for i in range(0, len(td), 7):
        assert_same(jd[i], td[i], f"validation[{i}]")


def test_load_dataset_statistics_matches_jax(tmp_path):
    """A statistics.yaml's entries replace the config's of the same target
    (the calvin_agent targets renamed), others are appended; a split
    without the file keeps the config's."""
    train, val = tmp_path / "training", tmp_path / "validation"
    train.mkdir()
    val.mkdir()
    (train / "statistics.yaml").write_text(
        "robot_obs:\n"
        "  - _target_: calvin_agent.utils.transforms.NormalizeVector\n"
        "    mean: [0.1, 0.2]\n    std: [1.0, 2.0]\n"
        "  - _target_: calvin_agent.utils.transforms.AddNoise\n"
        "    std: 0.01\n"
        "act_min_bound: [-1.0]\n")
    transforms = {
        "train": {"robot_obs": [
            {"_target_": "mode.utils.transforms.NormalizeVector"}],
            "rgb_static": [{"_target_": "torchvision.transforms.Resize",
                            "size": 224}]},
        "val": {"robot_obs": [
            {"_target_": "mode.utils.transforms.NormalizeVector"}]}}
    want = jep.load_dataset_statistics(train, val, copy.deepcopy(transforms))
    got = tep.load_dataset_statistics(train, val, copy.deepcopy(transforms))
    assert got == want
    assert got["train"]["robot_obs"][0]["mean"] == [0.1, 0.2]
    assert got["train"]["robot_obs"][1]["_target_"].startswith("mode.")
    assert got["val"] == transforms["val"]


def test_episode_helpers_match_jax(root):
    assert (tep.lookup_naming_pattern(root / "training", "npz")
            == jep.lookup_naming_pattern(root / "training", "npz"))
    ep = dict(np.load(root / "training" / "episode_0000003.npz"))
    ep["language"] = np.ones(384, np.float32)
    for fn in ("process_state", "process_rgb", "process_depth",
               "process_actions"):
        args = (ep, tds.DEFAULT_OBS_SPACE) + (
            (tds.DEFAULT_PROPRIO,) if fn == "process_state" else ())
        assert_same(getattr(jep, fn)(*args), getattr(tep, fn)(*args), fn)
    assert_same(jep.get_state_info_dict(ep), tep.get_state_info_dict(ep))
    assert_same(jep.process_language(ep, True),
                tep.process_language(ep, True))


def test_extract_by_key_writes_jax_files(root, tmp_path):
    """The packed actions and the name index, byte for byte; an existing
    file is kept unless forced; the CLI's main writes the same."""
    jout = jpre.extract_by_key(root / "training", "rel_actions",
                               out_dir=str(tmp_path / "jax"), workers=2)
    tout = tpre.extract_by_key(root / "training", "rel_actions",
                               out_dir=str(tmp_path / "port"), workers=2)
    for name in ("ep_rel_actions.npy", "ep_npz_names.list"):
        assert (pathlib.Path(jout, name).read_bytes()
                == pathlib.Path(tout, name).read_bytes()), name
    assert tpre.list_episode_files(str(root / "training")) == \
        jpre.list_episode_files(str(root / "training"))
    before = os.path.getmtime(pathlib.Path(tout, "ep_rel_actions.npy"))
    tpre.extract_by_key(root / "training", "rel_actions", out_dir=tout)
    assert os.path.getmtime(pathlib.Path(tout, "ep_rel_actions.npy")) == \
        before
    tpre.main(["--in-root", str(root / "training"), "--extract-key",
               "actions", "--out-dir", str(tmp_path / "cli"),
               "--workers", "2"])
    jpre.extract_by_key(root / "training", "actions",
                        out_dir=str(tmp_path / "jax"), workers=2)
    assert ((tmp_path / "cli" / "ep_actions.npy").read_bytes()
            == (tmp_path / "jax" / "ep_actions.npy").read_bytes())


def _shm_files(tag):
    return sorted(p.name for p in pathlib.Path("/dev/shm").glob(
        f"{tshm.SEGMENT_PREFIX}{tag}*"))


def test_shm_cache_names_attach_and_cleanup(root, tmp_path):
    """The port's names cannot collide with the JAX package's; a cache
    serves the npz values, attaches from its lookup file and by pickling,
    and leaves no segment or lookup file after cleanup."""
    tag = f"t{os.getpid()}_{tmp_path.name}"
    assert tshm.segment_name(tag, "rgb_static") != f"mode_tpu_{tag}_rgb_static"
    assert tshm.lookup_path(tag) != jshm._lookup_path(tag)
    keys = ["rgb_static", "robot_obs", "rel_actions"]
    cache = tshm.SharedEpisodeCache.build(root / "training", keys=keys,
                                          tag=tag, workers=2)
    try:
        assert len(_shm_files(tag)) == 3
        assert os.path.exists(tshm.lookup_path(tag))
        other = tshm.SharedEpisodeCache.attach(tag)
        clone = pickle.loads(pickle.dumps(cache))
        for ep_id in (0, 17, 89):
            raw = np.load(root / "training" / f"episode_{ep_id:07d}.npz")
            for k in keys:
                for c in (cache, other, clone):
                    np.testing.assert_array_equal(c.episode(ep_id, k), raw[k])
        assert "rel_actions" in cache and "actions" not in cache
        other.cleanup()
        clone.cleanup()
        assert len(_shm_files(tag)) == 3     # only the owner unlinks
    finally:
        cache.cleanup()
    assert _shm_files(tag) == []
    assert not os.path.exists(tshm.lookup_path(tag))
    cache.cleanup()                          # idempotent


@pytest.fixture(scope="module")
def jax_stream(root):
    """JAX's batches (inline, no cache): train epochs 0 and 1, then val."""
    dm = jdm.CalvinDataModule(root, batch_size=4, act_seq_len=10,
                              use_extracted_rel_actions=True,
                              lang_embed=fake_lang).setup()
    return {"train": [list(dm.train_batches(epoch=e)) for e in (0, 1)],
            "val": [list(dm.val_batches(epoch=e)) for e in (0, 1)]}


def _assert_stream(want, got, what):
    assert len(want) == len(got) > 0, what
    for i, (a, b) in enumerate(zip(want, got)):
        assert a["lang_text"] == b["lang_text"], (what, i)
        for k in BATCH_KEYS:
            v = b[k]
            if isinstance(v, torch.Tensor):
                v = v.numpy()
            assert v.dtype == a[k].dtype, (what, i, k)
            np.testing.assert_array_equal(a[k], v, err_msg=f"{what}[{i}].{k}")


@pytest.mark.parametrize(
    "workers,shm", [(0, False), (0, True), (2, False), (2, True)],
    ids=["inline", "inline-shm", "workers", "workers-shm"])
def test_datamodule_batches_match_jax(root, jax_stream, tmp_path, workers,
                                      shm):
    tag = f"t{os.getpid()}_{tmp_path.name}"
    dm = tdm.CalvinDataModule(root, batch_size=4, act_seq_len=10,
                              use_extracted_rel_actions=True,
                              lang_embed=fake_lang, num_workers=workers,
                              use_shm_cache=shm, shm_tag=tag).setup()
    try:
        assert len(_shm_files(tag)) == (10 if shm else 0)
        for e in (0, 1):
            _assert_stream(jax_stream["train"][e],
                           list(dm.train_batches(epoch=e)), f"train{e}")
            _assert_stream(jax_stream["val"][e],
                           list(dm.val_batches(epoch=e)), f"val{e}")
        assert not np.array_equal(jax_stream["train"][0][0]["idx"],
                                  jax_stream["train"][1][0]["idx"])
    finally:
        dm.close()
    assert _shm_files(tag) == []


def test_lang_cache_embeddings_stay_tensors(root, jax_stream):
    """With the port's LangEmbeddingCache as the embedder, ``lang_emb`` is
    the cache's tensor (not copied to numpy) with JAX's values, inline and
    from the workers; the encoder runs once per distinct instruction."""
    cache = LangEmbeddingCache(lambda texts: torch.from_numpy(
        fake_lang(texts)))
    for workers in (0, 2):
        dm = tdm.CalvinDataModule(root, batch_size=4, act_seq_len=10,
                                  use_extracted_rel_actions=True,
                                  lang_embed=cache,
                                  num_workers=workers).setup()
        got = list(dm.train_batches(epoch=1))
        assert all(isinstance(b["lang_emb"], torch.Tensor) for b in got)
        _assert_stream(jax_stream["train"][1], got, f"workers={workers}")
    assert cache.encoded_texts == len(INSTRUCTIONS)


def test_builder_reads_the_shipped_config(root, tmp_path):
    """``build_calvin_datamodule`` on ``conf/datamodule/calvin.yaml`` as
    the loader resolves it builds JAX's module: the same datasets and
    the same first batches."""
    from mode_diffusion_policy_tpu.config import builders as jb
    from mode_diffusion_policy_tpu_torch.config import builders as tb
    from mode_diffusion_policy_tpu_torch.config.loader import load_config
    conf = pathlib.Path(__file__).resolve().parents[1] / "conf"
    cfg = load_config(conf, "config_calvin", overrides=[
        f"root_data_dir={root}", "batch_size=4", "num_workers=0"])
    jd = jb.build_calvin_datamodule(cfg["datamodule"],
                                    lang_embed=fake_lang).setup()
    td = tb.build_calvin_datamodule(cfg["datamodule"], lang_embed=fake_lang,
                                    shm_tag=f"t{tmp_path.name}").setup()
    assert td.use_extracted_rel_actions and td.batch_size == 4
    assert len(td.train_dataset) == len(jd.train_dataset)
    want = list(jd.train_batches(epoch=2))[:3]
    _assert_stream(want, list(td.train_batches(epoch=2))[:3], "builder")


class _Boom:
    """Module-level so forkserver workers can unpickle it: the failure
    happens in the child and must reach the parent."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        raise ValueError("synthetic loader failure")


def test_worker_failures_raise_in_the_parent(root):
    dm = tdm.CalvinDataModule(root, batch_size=4, act_seq_len=10,
                              num_workers=2).setup()
    dm.train_dataset = _Boom()
    with pytest.raises(RuntimeError, match="loader worker failed: .*"
                       "synthetic loader failure"):
        next(dm.train_batches(epoch=0))

    class Local:   # unpicklable: defined inside the test function
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return {}

    dm.train_dataset = Local()
    with pytest.raises(RuntimeError, match="failed to start"):
        next(dm.train_batches(epoch=0))


class _CountingDataset:
    """Counts every __getitem__ in a shared counter, to see how far ahead a
    worker runs."""

    def __init__(self, n, counter):
        self.n = n
        self.counter = counter

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.counter.get_lock():
            self.counter.value += 1
        return {"rgb_obs": {"rgb_static": np.zeros((1, 4, 4, 3), np.uint8),
                            "rgb_gripper": np.zeros((1, 4, 4, 3), np.uint8)},
                "actions": np.zeros((10, 7), np.float32),
                "robot_obs": np.zeros((1, 8), np.float32),
                "idx": i, "lang_text": "t"}


def test_worker_queues_are_bounded():
    """A fast worker blocks after QUEUE_DEPTH undelivered batches."""
    counter = mp.get_context("forkserver").Value("i", 0)
    bs, n_batches = 2, 12
    ds = _CountingDataset(bs * n_batches, counter)
    it = iter(tdm._WorkerPool(ds, np.arange(len(ds)), bs, num_workers=1))
    next(it)
    prev = -1
    for _ in range(40):
        cur = counter.value
        if cur == prev:
            break
        prev = cur
        time.sleep(0.5)
    assert counter.value <= bs * (1 + tdm._WorkerPool.QUEUE_DEPTH + 2), \
        counter.value
    assert len(list(it)) == n_batches - 1
    assert counter.value == bs * n_batches


def test_lang_embeddings_match_jax(tmp_path):
    (tmp_path / "lang_annotations").mkdir()
    rng = np.random.default_rng(0)
    table = {t: {"emb": rng.standard_normal((1, 1, 32)).astype(np.float64),
                 "ann": [t]} for t in INSTRUCTIONS}
    np.save(tmp_path / "lang_annotations" / "embeddings.npy",
            np.asarray(table, dtype=object), allow_pickle=True)
    j, t = jeval.LangEmbeddings(tmp_path), teval.LangEmbeddings(tmp_path)
    for task in INSTRUCTIONS:
        assert_same(j.get_lang_goal(task), t.get_lang_goal(task), task)
        assert t.get_lang_goal(task)["lang"].shape == (32,)


_STOP_SCRIPT = """
import json, runpy, subprocess, sys
sys.path.insert(0, {repo!r})
from mode_diffusion_policy_tpu_torch.data import datamodule as tdm
smoke = runpy.run_path({smoke!r}, run_name="chip_smoke_stop")

def main():
    dm = tdm.CalvinDataModule({root!r}, batch_size=4, act_seq_len=10,
                              num_workers=2, use_shm_cache=True,
                              shm_tag={tag!r}).setup()
    it = dm.train_batches(epoch=0)
    next(it)
    it.close()
    dm.close()
    helpers = smoke["descendants"]()
    tdm.stop_helper_processes()
    after = smoke["descendants"]()
    subprocess.Popen(["sleep", "60"])
    stray = smoke["descendants"]()
    smoke["stop_children"]()
    print(json.dumps({{"helpers": helpers, "after": after, "stray": stray,
                      "end": smoke["descendants"]()}}))

if __name__ == "__main__":
    main()
"""


def test_helper_processes_stop_before_exit(root, tmp_path):
    """The loader's fork server and the resource tracker, which otherwise
    outlive their process by a moment, are gone once
    ``stop_helper_processes`` returns; ``chip_smoke.stop_children`` also
    kills any other process below its own."""
    import json
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parents[1]
    script = tmp_path / "stop.py"
    script.write_text(_STOP_SCRIPT.format(
        repo=str(repo), smoke=str(repo / "chip_smoke.py"), root=str(root),
        tag=f"stop{tmp_path.name}"))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["helpers"]) >= 2, got  # the fork server and the tracker
    assert got["after"] == [], got
    assert len(got["stray"]) == 1 and got["end"] == [], got
    assert "killed 1 leftover" in out.stderr, out.stderr[-3000:]
    assert not _shm_files(f"stop{tmp_path.name}_training"), \
        _shm_files(f"stop{tmp_path.name}_training")
