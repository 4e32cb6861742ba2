"""Language-annotation tools: the manual annotation loop and the
oracle-driven automatic annotator (counterpart of
``mode_diffusion_policy_tpu/utils/lang_annotators.py``).

- ``manual_annotate`` (the reference ``language_annotator.py``): walk a
  sampled subset of a dataset's windows, ask for an instruction per window,
  append to ``lang_ann.npy`` (resumable) and optionally embed the
  instructions with a language encoder. Frames are shown only on request
  (headless runs print the index ranges).
- ``auto_annotate`` (the reference ``automatic_lang_annotator_mp.py``):
  find the task each window demonstrates by resetting the env to the
  window's first and last states and asking the task oracle what changed,
  then label it with a random annotation of that task and embed the
  labels.

They run over the port's datasets (``data.calvin_dataset``), the fake env
(``rollout.env``) and the port's ``LangClip``, whose embeddings (a tensor on
its device) are written to the ``.npy`` files as host arrays, in the JAX
tools' file format.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _host(emb) -> np.ndarray:
    """An encoder's output (a tensor on any device, or an array) on the
    host."""
    if isinstance(emb, torch.Tensor):
        return emb.detach().cpu().numpy()
    return np.asarray(emb)


def manual_annotate(dataset, *, out_dir: str, sample_fraction: float = 0.01,
                    lang_encoder: Optional[Callable] = None,
                    prompt: Callable[[str], str] = input,
                    show_frames: bool = False) -> Dict:
    """The interactive annotation loop: ``prompt`` (``input`` by default)
    asks for each sampled window's instruction, "q" stops. Resumable: it
    appends to an existing ``lang_ann.npy`` in ``out_dir``."""
    file_name = os.path.join(out_dir, "lang_ann.npy")
    if os.path.isfile(file_name):
        collected = np.load(file_name, allow_pickle=True).reshape(-1)[0]
        start = len(collected["indx"])
        logger.info("resuming at annotation %d", start)
    else:
        collected = {"language": [], "indx": []}
        start = 0

    length = len(dataset)
    steps = max(1, int((length - start) // max(length * sample_fraction, 1)))
    for i in range(start, length, steps):
        item = dataset[i]
        ep_start = int(dataset.episode_lookup[i])
        window = len(item["actions"])
        if show_frames:  # pragma: no cover - needs a display
            import matplotlib.pyplot as plt
            plt.imshow(item["rgb_obs"]["rgb_static"][0])
            plt.show(block=False)
        ann = prompt(
            f"[frames {ep_start}..{ep_start + window}] instruction "
            "(q to quit): ")
        if show_frames:  # pragma: no cover
            import matplotlib.pyplot as plt
            plt.close()
        if ann == "q":
            break
        collected["language"].append([ann])
        collected["indx"].append((ep_start, ep_start + window))
    np.save(file_name, np.asarray(collected, dtype=object),
            allow_pickle=True)
    if lang_encoder is not None:
        texts = [t for sub in collected["language"] for t in sub]
        emb = _host(lang_encoder(texts))
        np.save(os.path.join(out_dir, "lang_emb_ann.npy"),
                np.asarray({"language": emb, "indx": collected["indx"]},
                           dtype=object), allow_pickle=True)
        logger.info("embedded %d annotations", len(texts))
    return collected


def auto_annotate(sequences: Sequence[Dict], env, task_oracle,
                  annotations: Dict[str, List[str]], *,
                  lang_encoder: Optional[Callable] = None,
                  out_dir: Optional[str] = None,
                  rng: Optional[np.random.Generator] = None) -> Dict:
    """Oracle-driven annotation: for each window {'state_info': ...,
    'indx': (start, end)}, reset the env to the window's first and last
    states, ask ``task_oracle`` which tasks were achieved, and label a
    window with exactly one task with a random annotation of it (drawn
    from ``rng``); ambiguous and empty windows are skipped."""
    rng = rng or np.random.default_rng(0)
    collected: Dict = {"language": {"ann": [], "task": [], "emb": None},
                       "info": {"indx": []}}
    for seq in sequences:
        state_info = seq["state_info"]
        env.reset(robot_obs=np.asarray(state_info["robot_obs"][0]),
                  scene_obs=np.asarray(state_info["scene_obs"][0]))
        start_info = env.get_info()
        env.reset(robot_obs=np.asarray(state_info["robot_obs"][-1]),
                  scene_obs=np.asarray(state_info["scene_obs"][-1]))
        end_info = env.get_info()
        tasks = task_oracle.get_task_info_for_set(
            start_info, end_info, set(annotations.keys()))
        if len(tasks) != 1:
            continue  # ambiguous or empty
        task = next(iter(tasks))
        ann = annotations[task][int(rng.integers(len(annotations[task])))]
        collected["language"]["ann"].append(ann)
        collected["language"]["task"].append(task)
        collected["info"]["indx"].append(tuple(seq.get("indx", (0, 0))))
    if lang_encoder is not None and collected["language"]["ann"]:
        collected["language"]["emb"] = _host(
            lang_encoder(collected["language"]["ann"]))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "auto_lang_ann.npy"),
                np.asarray(collected, dtype=object), allow_pickle=True)
    logger.info("auto-annotated %d/%d windows",
                len(collected["language"]["ann"]), len(sequences))
    return collected
