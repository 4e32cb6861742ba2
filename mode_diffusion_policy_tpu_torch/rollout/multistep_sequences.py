"""CALVIN long-horizon evaluation chains: the 34-task symbolic state machine
and the deterministic 1000-chain generator (counterpart of
``mode_diffusion_policy_tpu/rollout/multistep_sequences.py``; numpy only,
copied, and made faster with the same draws: see ``_sequences_for_state``).

The task condition/effect tables are the CALVIN domain definition (data, built
here programmatically with identical dict insertion order — the order feeds
np.random.choice and must match for chain-level reproducibility), and
``get_sequences`` reproduces the reference's per-initial-state seeded
rejection sampling exactly (multistep_sequences.py:334-382).
"""
from __future__ import annotations

import functools
from itertools import product
from typing import Dict, List, Tuple

import numpy as np

from ..evaluation.utils import temp_seed

COLORS = ("red", "blue", "pink")


def _build_tables():
    task_categories: Dict[str, int] = {}
    tasks: Dict[str, list] = {}

    # rotate / push: category 1, tabletop-only manipulations
    for verb in ("rotate", "push"):
        for color in COLORS:
            for direction in ("right", "left"):
                name = f"{verb}_{color}_block_{direction}"
                task_categories[name] = 1
                tasks[name] = [{
                    "condition": {f"{color}_block": "table", "grasped": 0},
                    "effect": {f"{color}_block": "table"},
                }]

    task_categories["move_slider_left"] = 2
    tasks["move_slider_left"] = [{
        "condition": {"slider": "right", "grasped": 0},
        "effect": {"slider": "left"}}]
    task_categories["move_slider_right"] = 2
    tasks["move_slider_right"] = [{
        "condition": {"slider": "left", "grasped": 0},
        "effect": {"slider": "right"}}]
    task_categories["open_drawer"] = 3
    tasks["open_drawer"] = [{
        "condition": {"drawer": "closed", "grasped": 0},
        "effect": {"drawer": "open"}}]
    task_categories["close_drawer"] = 3
    tasks["close_drawer"] = [{
        "condition": {"drawer": "open", "grasped": 0},
        "effect": {"drawer": "closed"}}]

    for i, color in enumerate(COLORS):
        blk = f"{color}_block"
        task_categories[f"lift_{blk}_table"] = 4
        tasks[f"lift_{blk}_table"] = [{
            "condition": {blk: "table", "grasped": 0},
            "effect": {blk: "grasped", "grasped": 1}}]
        task_categories[f"lift_{blk}_slider"] = 5
        tasks[f"lift_{blk}_slider"] = [
            {"condition": {blk: "slider_left", "slider": "right", "grasped": 0},
             "effect": {blk: "grasped", "grasped": 1}},
            {"condition": {blk: "slider_right", "slider": "left", "grasped": 0},
             "effect": {blk: "grasped", "grasped": 1}},
        ]
        task_categories[f"lift_{blk}_drawer"] = 6
        tasks[f"lift_{blk}_drawer"] = [{
            "condition": {blk: "drawer", "drawer": "open", "grasped": 0},
            "effect": {blk: "grasped", "grasped": 1}}]

    task_categories["place_in_slider"] = 7
    tasks["place_in_slider"] = [
        {"condition": {f"{c}_block": "grasped", "slider": side, "grasped": 1},
         "effect": {f"{c}_block": f"slider_{side}", "grasped": 0}}
        for c in COLORS for side in ("right", "left")]
    task_categories["place_in_drawer"] = 7
    tasks["place_in_drawer"] = [
        {"condition": {f"{c}_block": "grasped", "drawer": "open", "grasped": 1},
         "effect": {f"{c}_block": "drawer", "grasped": 0}}
        for c in COLORS]

    task_categories["stack_block"] = 10
    tasks["stack_block"] = [
        {"condition": {f"{top}_block": "grasped", f"{bot}_block": "table",
                       "grasped": 1},
         "effect": {f"{top}_block": "stacked_top",
                    f"{bot}_block": "stacked_bottom", "grasped": 0}}
        for top in COLORS for bot in COLORS if top != bot]
    task_categories["unstack_block"] = 11
    tasks["unstack_block"] = [
        {"condition": {f"{top}_block": "stacked_top",
                       f"{bot}_block": "stacked_bottom", "grasped": 0},
         "effect": {f"{top}_block": "table", f"{bot}_block": "table"}}
        for top in COLORS for bot in COLORS if top != bot]

    for thing in ("lightbulb", "led"):
        task_categories[f"turn_on_{thing}"] = 8
        tasks[f"turn_on_{thing}"] = [{
            "condition": {thing: 0, "grasped": 0}, "effect": {thing: 1}}]
        task_categories[f"turn_off_{thing}"] = 8
        tasks[f"turn_off_{thing}"] = [{
            "condition": {thing: 1, "grasped": 0}, "effect": {thing: 0}}]

    task_categories["push_into_drawer"] = 9
    tasks["push_into_drawer"] = []
    for c in COLORS:
        others = [f"{o}_block" for o in COLORS if o != c]
        cond = {f"{c}_block": "table"}
        for o in others:
            cond[o] = ["slider_right", "slider_left"]
        cond.update({"drawer": "open", "grasped": 0})
        tasks["push_into_drawer"].append(
            {"condition": cond, "effect": {f"{c}_block": "drawer",
                                           "grasped": 0}})
    return task_categories, tasks


task_categories, tasks = _build_tables()


def check_condition(state, condition) -> bool:
    for k, v in condition.items():
        if isinstance(v, (str, int)):
            if state[k] != v:
                return False
        elif isinstance(v, list):
            if state[k] not in v:
                return False
        else:
            raise TypeError(type(v))
    return True


def update_state(state, effect):
    # every state and effect value is a str or an int: a shallow copy is
    # the JAX module's deepcopy
    return {**state, **effect}


def valid_task(curr_state, task):
    return [update_state(curr_state, t["effect"]) for t in task
            if check_condition(curr_state, t["condition"])]


def check_sequence(state, seq) -> bool:
    """A chain is valid iff each task has exactly one applicable variant and
    categories never repeat (multistep_sequences.py:324-331)."""
    # the cheap category test first (the JAX module tests it last; the
    # answer is the same)
    categories = [task_categories[name] for name in seq]
    if len(categories) != len(set(categories)):
        return False
    for task_name in seq:
        states = valid_task(state, tasks[task_name])
        if len(states) != 1:
            return False
        state = states[0]
    return True


def _sequences_for_state(state, num_sequences: int, seed: int):
    """Seeded rejection sampling (multistep_sequences.py:334-344)."""
    np.random.seed(seed)
    results = []
    names = list(tasks.keys())
    while len(results) < num_sequences:
        # np.random.choice(names, size=5, replace=False) draws exactly
        # this: the first 5 of a permutation (numpy's legacy RandomState)
        seq = [names[i] for i in np.random.permutation(len(names))[:5]]
        if check_sequence(state, seq):
            results.append(np.array(seq))
    return results


def initial_states() -> List[Dict]:
    """All physically-plausible symbolic initial states
    (multistep_sequences.py:352-365)."""
    possible_conditions = {
        "led": [0, 1],
        "lightbulb": [0, 1],
        "slider": ["right", "left"],
        "drawer": ["closed", "open"],
        "red_block": ["table", "slider_right", "slider_left"],
        "blue_block": ["table", "slider_right", "slider_left"],
        "pink_block": ["table", "slider_right", "slider_left"],
        "grasped": [0],
    }
    f = (lambda l: l.count("table") in [1, 2]
         and l.count("slider_right") < 2 and l.count("slider_left") < 2)
    combos = filter(f, product(*possible_conditions.values()))
    return [dict(zip(possible_conditions.keys(), vals)) for vals in combos]


@functools.lru_cache
def get_sequences(num_sequences: int = 1000
                  ) -> List[Tuple[Dict, Tuple[str, ...]]]:
    """num_sequences (initial_state, 5-task-chain) pairs, deterministic under
    temp_seed(0) (multistep_sequences.py:351-382)."""
    states = initial_states()
    per_state = list(map(len, np.array_split(range(num_sequences),
                                             len(states))))
    # Per-state sampling self-seeds with np.random.seed(i). The reference runs
    # these in *worker processes*, leaving the parent RNG untouched — so the
    # final shuffle below must see a fresh seed-0 stream. Sample first,
    # shuffle inside temp_seed(0).
    chains = []
    for i, (state, n) in enumerate(zip(states, per_state)):
        with temp_seed(i):
            for seq in _sequences_for_state(state, n, i):
                chains.append(tuple(seq.tolist()))
    with temp_seed(0):
        results = list(zip(np.repeat(states, per_state), chains))
        np.random.shuffle(results)
    return results
