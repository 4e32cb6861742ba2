"""The port's CALVIN chain generator against the JAX package's: all 1000
(initial state, chain) pairs of ``get_sequences(1000)`` equal, and the
pieces of the port's faster sampler against what they stand for: the
bulk swap partners and chains against ``np.random.permutation`` on the
same legacy stream, the transition table against ``check_sequence``, and
``_sequences_for_state`` against the JAX function draw for draw. Its own
file, so that a worker of the suite runs the long 1000-pair test alone."""
import numpy as np
import pytest

from mode_diffusion_policy_tpu.rollout import multistep_sequences as jms
from mode_diffusion_policy_tpu_torch.rollout import multistep_sequences as tms
from torch_threads import two_torch_threads  # noqa: F401


def test_get_sequences_1000_match():
    got, want = tms.get_sequences(1000), jms.get_sequences(1000)
    assert len(got) == len(want) == 1000
    for (gs, gseq), (ws, wseq) in zip(got, want):
        assert gs == ws and tuple(gseq) == tuple(wseq)


@pytest.mark.parametrize("seed", [0, 7, 191])
def test_bulk_draws_are_the_permutations(seed):
    """``_swap_partners`` then ``_chains`` give the first 5 of each of
    ``np.random.permutation(34)``'s draws, and leave the stream where
    those draws leave it."""
    n = 3000
    np.random.seed(seed)
    want = np.stack([np.random.permutation(tms.N_TASKS)[:tms.CHAIN]
                     for _ in range(n)])
    after = np.random.randint(1 << 30, size=4)
    np.random.seed(seed)
    got = tms._chains(tms._swap_partners(n))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.random.randint(1 << 30, size=4), after)


def test_task_table_is_check_sequence():
    """The table's verdict equals ``check_sequence`` (the port's and
    JAX's) on random chains from every initial state, accepted and
    refused ones both present."""
    states = tms.initial_states()
    table = tms.TaskTable(states)
    r = np.random.default_rng(0)
    chains = np.stack([r.permutation(tms.N_TASKS)[:tms.CHAIN]
                       for _ in range(400)])
    accepted = 0
    for state in states[::5]:
        got = table.valid(table.id_of(state), chains)
        for c, g in zip(chains, got):
            names = [tms.NAMES[i] for i in c]
            assert g == tms.check_sequence(state, names) \
                == jms.check_sequence(state, names)
        accepted += int(got.sum())
    assert 0 < accepted < len(chains) * len(states[::5])
    with pytest.raises(KeyError):
        tms.TaskTable(states[:1]).id_of(states[1])


@pytest.mark.parametrize("index", [0, 101])
def test_sequences_for_state_match(index):
    """Both packages' ``_sequences_for_state`` give the same chains as
    arrays of the same dtype and leave the global stream at the same
    place; the port's with its own table and with the shared one."""
    state = tms.initial_states()[index]
    want = jms._sequences_for_state(state, 3, index)
    after = np.random.randint(1 << 30)
    for table in (None, tms.TaskTable(tms.initial_states())):
        got = tms._sequences_for_state(state, 3, index, table)
        assert np.random.randint(1 << 30) == after
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert len(got) == len(want) == 3
