"""Rollout video assembly: frame accumulation, success/failure border
painting, language captions, mp4/GIF export (counterpart of
``mode_diffusion_policy_tpu/rollout/video.py``; numpy only, copied).

Numpy frames in, an mp4 (``cv2``) or a wandb GIF out. ``cv2`` and ``wandb``
are imported only where a file is written or a video logged.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

GREEN = np.array([0, 200, 0], np.uint8)
RED = np.array([200, 0, 0], np.uint8)


class RolloutVideo:
    def __init__(self, save_dir: str = "./videos", fps: int = 15,
                 log_to_file: bool = True, wandb_run=None,
                 border_frames: int = 10):
        self.save_dir = save_dir
        self.fps = fps
        self.log_to_file = log_to_file
        self.wandb_run = wandb_run
        self.border_frames = border_frames
        self._videos: Dict[str, List[np.ndarray]] = {}
        self._tag: Optional[str] = None
        self._subtask_start = 0
        self._captions: Dict[str, List[str]] = {}

    def new_video(self, tag: str, caption: str = ""):
        self._tag = tag
        self._videos[tag] = []
        self._captions[tag] = [caption] if caption else []
        self._subtask_start = 0

    def new_subtask(self):
        self._subtask_start = len(self._videos[self._tag])

    def update(self, rgb_static):
        """Append one frame; accepts [H,W,3], [1,1,H,W,3] or [1,H,W,3]."""
        frame = np.asarray(rgb_static)
        while frame.ndim > 3:
            frame = frame[0]
        self._videos[self._tag].append(frame.astype(np.uint8))

    def draw_outcome(self, success: bool):
        """Paint a success/failure border on the trailing frames of the
        current subtask (rollout_video.py:76-97)."""
        color = GREEN if success else RED
        frames = self._videos[self._tag]
        for i in range(max(self._subtask_start,
                           len(frames) - self.border_frames), len(frames)):
            f = frames[i].copy()
            f[:3, :] = color
            f[-3:, :] = color
            f[:, :3] = color
            f[:, -3:] = color
            frames[i] = f

    def add_language_instruction(self, text: str):
        self._captions[self._tag].append(text)

    def write_to_tmp(self):
        pass  # frames already buffered host-side

    def log(self, step: int = 0):
        """Flush all buffered videos (rollout_video.py:126-294)."""
        os.makedirs(self.save_dir, exist_ok=True)
        for tag, frames in self._videos.items():
            if not frames:
                continue
            if self.log_to_file:
                self._write_mp4(tag, frames)
            if self.wandb_run is not None:
                try:
                    import wandb
                    arr = np.stack(frames).transpose(0, 3, 1, 2)
                    self.wandb_run.log(
                        {f"video/{tag}": wandb.Video(arr, fps=self.fps,
                                                     format="gif")},
                        step=step)
                except Exception as e:  # wandb optional
                    logger.warning("wandb video log failed: %s", e)
        self._videos.clear()
        self._captions.clear()

    def _write_mp4(self, tag: str, frames: List[np.ndarray]):
        import cv2
        path = os.path.join(self.save_dir, f"{tag}.mp4")
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 self.fps, (w, h))
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        logger.info("wrote %s (%d frames)", path, len(frames))
