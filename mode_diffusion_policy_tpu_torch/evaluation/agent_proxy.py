"""Pickle-over-HTTP policy server, the "agent proxy" (counterpart of
``mode_diffusion_policy_tpu/evaluation/agent_proxy.py``).

A small HTTP server that hosts a policy and dispatches pickled method
calls: ``__init__`` (re)creates the agent, ``__call__`` invokes it, any
other ``method`` name is forwarded, ``__shutdown__`` stops the server. On a
handler exception the agent is dropped, and the next ``__init__`` creates
it anew. The wrapper adapts raw CALVIN observations and binarizes the
gripper, so remote callers send raw env obs. Requests are unpickled, which
can run code: serve only trusted clients.

Server:  python -m mode_diffusion_policy_tpu_torch.evaluation.agent_proxy --port 9088
Client:  AgentProxyClient("http://host:9088").step(obs, "open the drawer")
"""
from __future__ import annotations

import argparse
import logging
import pickle
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


class CalvinAgentWrapper:
    """Raw CALVIN obs -> policy step -> de-normalized action. The policy
    preprocesses the frames (``evaluate_calvin.PreprocPolicy``: on the card,
    once per chunk); the wrapper batches them as [1, 1, H, W, 3] uint8 and
    slices the proprio state."""

    def __init__(self, policy, observation_space_keys: Dict,
                 proprio_state: Dict, image_size: int = 224):
        self.policy = policy
        self.observation_space_keys = observation_space_keys
        self.proprio_state = proprio_state
        self.relative_actions = (
            "rel_actions" in observation_space_keys["actions"])
        self.image_size = image_size

    def __getattr__(self, attr):
        return getattr(self.policy, attr)

    def step(self, obs: Dict, lang_annotation: str):
        obs_t = self._transform_observation(obs)
        action = self.policy.step(obs_t, {"lang_text": lang_annotation})
        return self._transform_action(np.asarray(action))

    def _transform_action(self, action: np.ndarray):
        action = action.squeeze()
        if self.relative_actions:
            assert action.shape[-1] == 7
            action = np.array(action, np.float64)
            action[-1] = 1 if action[-1] > 0 else -1
            return action
        if action.shape[-1] == 7:
            parts = np.split(action, [3, 6])
        elif action.shape[-1] == 8:
            parts = np.split(action, [3, 7])
        else:
            raise NotImplementedError(action.shape)
        parts[-1] = np.array([1 if parts[-1] > 0 else -1])
        return parts

    def _transform_observation(self, obs: Dict) -> Dict:
        out: Dict[str, Any] = {"rgb_obs": {}}
        for key in self.observation_space_keys["rgb_obs"]:
            out["rgb_obs"][key] = np.asarray(obs["rgb_obs"][key],
                                             np.uint8)[None, None]
        robot = np.asarray(obs["robot_obs"], np.float32)
        sliced = [robot[slice(*ids)]
                  for ids in self.proprio_state["keep_indices"]]
        out["robot_obs"] = np.concatenate(sliced)[None, None]
        return out


class AgentHandler(BaseHTTPRequestHandler):
    """Dispatches one request; ``start_server`` gives each server its own
    subclass, which holds that server's ``create_agent`` and agent."""

    create_agent: Optional[Callable] = None
    agent = None

    def log_message(self, fmt, *args):  # quiet
        logger.debug(fmt, *args)

    def do_POST(self):  # noqa: N802
        cls = type(self)
        content_length = int(self.headers["Content-Length"])
        request = pickle.loads(self.rfile.read(content_length))
        method = request.get("method")
        try:
            if method == "__shutdown__":
                cls.agent = None
                self._respond({"result": "shutdown"})
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            if method == "__init__":
                cls.agent = cls.create_agent()
                self._respond({"result": "agent created"})
                return
            agent = cls.agent
            if agent is None:
                raise RuntimeError("agent not initialized; call __init__")
            args = request.get("args", [])
            kwargs = request.get("kwargs", {})
            if method == "__call__":
                result = agent(*args, **kwargs)
            else:
                result = getattr(agent, method)(*args, **kwargs)
            self._respond({"result": result})
        except Exception as e:  # a boundary that keeps serving
            logger.exception("handler error; dropping the agent")
            cls.agent = None
            self._respond({"error": repr(e)}, code=500)

    def _respond(self, payload: Dict, code: int = 200):
        body = pickle.dumps(payload)
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def start_server(create_agent: Callable, host: str = "0.0.0.0",
                 port: int = 9088, background: bool = False) -> HTTPServer:
    """Serve ``create_agent()``'s agent on ``host:port``: forever, or in a
    daemon thread with ``background`` (stop it with ``__shutdown__`` or
    ``server.shutdown()``; ``server.server_close()`` frees the port)."""
    handler = type("AgentHandler", (AgentHandler,),
                   {"create_agent": staticmethod(create_agent),
                    "agent": None})
    server = HTTPServer((host, port), handler)
    logger.info("agent proxy listening on %s:%d", host,
                server.server_address[1])
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return server


class AgentProxyClient:
    """Client side: pickled method calls over HTTP POST."""

    def __init__(self, url: str):
        self.url = url

    def _call(self, method: str, *args, **kwargs):
        import urllib.error
        import urllib.request
        body = pickle.dumps({"method": method, "args": list(args),
                             "kwargs": kwargs})
        req = urllib.request.Request(self.url, data=body, method="POST")
        try:
            with urllib.request.urlopen(req) as resp:
                payload = pickle.loads(resp.read())
        except urllib.error.HTTPError as e:
            payload = pickle.loads(e.read())
        if "error" in payload:
            raise RuntimeError(payload["error"])
        return payload["result"]

    def init(self):
        return self._call("__init__")

    def __call__(self, *args, **kwargs):
        return self._call("__call__", *args, **kwargs)

    def step(self, obs, lang_annotation):
        return self._call("step", obs, lang_annotation)

    def reset(self):
        return self._call("reset")

    def shutdown(self):
        return self._call("__shutdown__")


def make_agent_factory(args) -> Callable[[], CalvinAgentWrapper]:
    """``create_agent`` of the CLI: the agent of ``evaluate_calvin
    .build_agent`` (the flagship sampler settings, EMA weights, the serving
    preset) behind a ``PreprocPolicy`` with a language cache, wrapped."""
    from types import SimpleNamespace

    from ..config.builders import build_lang_clip
    from ..data.calvin_dataset import DEFAULT_OBS_SPACE, DEFAULT_PROPRIO
    from ..models.encoders.lang_cache import LangEmbeddingCache
    from .evaluate_calvin import CAMERAS, PreprocPolicy, build_agent

    def create_agent():
        ns = SimpleNamespace(
            checkpoint=args.checkpoint, sampler_type="ddim",
            num_sampling_steps=10, noise_scheduler="exponential",
            sigma_min=0.001, sigma_max=80.0, latent_dim=args.latent_dim,
            n_layers=args.n_layers, resnet_type=args.resnet_type,
            image_size=args.image_size, bf16=False, no_ema=False,
            serving_mode=args.serving_mode, device=args.device)
        agent = build_agent(ns)
        lang = build_lang_clip(clip_checkpoint=args.clip_checkpoint,
                               device=agent.device)
        policy = PreprocPolicy(agent, LangEmbeddingCache(lang),
                               sizes={c: args.image_size for c in CAMERAS})
        return CalvinAgentWrapper(policy, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO,
                                  image_size=args.image_size)

    return create_agent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=9088)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--latent-dim", type=int, default=1024)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--resnet-type", default="50")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--clip-checkpoint", default=None)
    p.add_argument("--serving-mode", default="auto",
                   help="serving preset (serving.SERVING_MODES)")
    p.add_argument("--sampler-unroll", type=int, default=1,
                   help="accepted for the JAX CLI's flag set; no effect "
                        "here (see evaluate_calvin)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    start_server(make_agent_factory(args), args.host, args.port)


if __name__ == "__main__":
    main()
