"""CALVIN long-horizon evaluation chains: the 34-task symbolic state machine
and the deterministic 1000-chain generator (counterpart of
``mode_diffusion_policy_tpu/rollout/multistep_sequences.py``; numpy only,
copied, and made faster with the same draws: ``_sequences_for_state``
draws its permutations in blocks and checks them through a ``TaskTable``).

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


NAMES = tuple(tasks)
N_TASKS = len(NAMES)
CHAIN = 5
# the maxima of the legacy RandomState shuffle's bounded draws for one
# permutation of the task list: N_TASKS - 1 down to 1
SHUFFLE_MAXIMA = np.arange(N_TASKS - 1, 0, -1)
# permutations drawn and checked at a time (the last block of a state is
# drawn again up to its last accepted chain, to leave the stream there)
BLOCK = 8192
STATE_KEYS = ("led", "lightbulb", "slider", "drawer", "red_block",
              "blue_block", "pink_block", "grasped")


class TaskTable:
    """Every symbolic state reachable from ``states`` by ``CHAIN - 1`` tasks
    or fewer, numbered (the given states first), with the transition table
    ``next[state id, task index]``: the id of the one state the task leads
    to, or -1 where the task does not have exactly one applicable variant.
    A chain passes ``check_sequence`` from state id ``s`` iff the walk
    through the table never meets -1 and its categories differ."""

    def __init__(self, states):
        self.ids: Dict[tuple, int] = {}
        self.states: List[Dict] = []
        rows = {}
        frontier = [self._add(s) for s in states]
        self.starts = frozenset(frontier)
        for _ in range(CHAIN):
            known = len(self.states)
            for sid in frontier:
                rows[sid] = [self._after(sid, name) for name in NAMES]
            frontier = range(known, len(self.states))
        # the states first met CHAIN tasks away are never left: rows of -1
        self.next = np.full((len(self.states), N_TASKS), -1, np.int32)
        for sid, row in rows.items():
            self.next[sid] = row
        self.category = np.array([task_categories[n] for n in NAMES])

    def _add(self, state) -> int:
        key = tuple(state[k] for k in STATE_KEYS)
        if key not in self.ids:
            self.ids[key] = len(self.states)
            self.states.append(state)
        return self.ids[key]

    def _after(self, sid: int, name: str) -> int:
        nxt = valid_task(self.states[sid], tasks[name])
        return self._add(nxt[0]) if len(nxt) == 1 else -1

    def id_of(self, state) -> int:
        """The id of one of the states the table starts from."""
        sid = self.ids.get(tuple(state[k] for k in STATE_KEYS))
        if sid not in self.starts:
            raise KeyError(f"the table does not start from {state}")
        return sid

    def valid(self, sid: int, chains: np.ndarray) -> np.ndarray:
        """Whether each row of ``chains`` ([n, CHAIN] task indices) passes
        ``check_sequence`` from state id ``sid``."""
        cur = np.full(len(chains), sid, np.int32)
        ok = np.ones(len(chains), bool)
        for t in range(CHAIN):
            cur = self.next[cur, chains[:, t]]
            ok &= cur >= 0
            cur[~ok] = sid
        cats = np.sort(self.category[chains], axis=1)
        return ok & (cats[:, 1:] != cats[:, :-1]).all(axis=1)


def _swap_partners(n: int) -> np.ndarray:
    """The swap partners of ``n`` successive ``np.random.permutation(
    N_TASKS)`` draws ([n, N_TASKS - 1]), from the same legacy
    ``RandomState`` stream, leaving it where those draws leave it: a
    permutation is a Fisher-Yates shuffle whose k-th partner is a masked
    rejection draw in [0, N_TASKS - 1 - k], which is what the legacy
    ``randint`` draws for each element of an array of upper bounds."""
    return np.random.randint(0, np.tile(SHUFFLE_MAXIMA + 1, n),
                             dtype=np.uint32).reshape(n, N_TASKS - 1)


def _chains(partners: np.ndarray) -> np.ndarray:
    """The first ``CHAIN`` entries of the permutations that ``partners``
    (from ``_swap_partners``) shuffle ``arange(N_TASKS)`` into: [n,
    CHAIN]."""
    n = len(partners)
    perm = np.tile(np.arange(N_TASKS, dtype=np.int8)[:, None], (1, n))
    flat = perm.reshape(-1)
    at = partners.T.astype(np.intp) * n + np.arange(n)
    for k, i in enumerate(SHUFFLE_MAXIMA):
        if i < CHAIN:
            # both places are read later: swap
            perm[i], flat[at[k]] = flat[at[k]], perm[i].copy()
        else:
            # place i is final and never read again
            flat[at[k]] = perm[i]
    return perm[:CHAIN].T.astype(np.intp)


def _sequences_for_state(state, num_sequences: int, seed: int,
                         table: TaskTable = None):
    """Seeded rejection sampling (multistep_sequences.py:334-344): the
    first ``num_sequences`` draws of ``np.random.choice(names, 5,
    replace=False)`` after ``np.random.seed(seed)`` that pass
    ``check_sequence``, leaving the global stream where those draws leave
    it. ``choice`` takes the first 5 of a permutation; the permutations are
    drawn ``BLOCK`` at a time (``_swap_partners``, ``_chains``) and checked
    through ``table`` (a ``TaskTable`` starting from ``state``, built here
    if not given). Each chain is an array of task names, as ``choice``
    returns it."""
    np.random.seed(seed)
    table = table or TaskTable([state])
    sid = table.id_of(state)
    names = np.array(NAMES)
    results = []
    while len(results) < num_sequences:
        before = np.random.get_state()
        chains = _chains(_swap_partners(BLOCK))
        hits = np.flatnonzero(table.valid(sid, chains))
        need = num_sequences - len(results)
        results.extend(names[chains[h]] for h in hits[:need])
        if len(hits) >= need:
            # put the stream where the last accepted draw left it
            np.random.set_state(before)
            _swap_partners(int(hits[need - 1]) + 1)
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
    table = TaskTable(states)
    for i, (state, n) in enumerate(zip(states, per_state)):
        with temp_seed(i):
            for seq in _sequences_for_state(state, n, i, table):
                chains.append(tuple(seq.tolist()))
    with temp_seed(0):
        results = list(zip(np.repeat(states, per_state), chains))
        np.random.shuffle(results)
    return results
