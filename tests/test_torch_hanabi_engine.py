"""The port's Hanabi engine and fleet against the JAX package's.

* Engine lockstep, bit-exact, against `jax_engine` for every configuration
  of tests/test_jax_hanabi.py (2p and 3p, Full, Minimal, Small): a fleet
  of games from the same injected decks, driven with the same random
  moves (legal ones, −1 no-ops and illegal ones); after every move every
  state field, both encodings of every player, the legal masks, reward,
  score and terminal are compared with `assert_array_equal`.
* One lockstep against the C++ engine (`cpp/hanabi` through
  `onpolicy_tpu.envs.hanabi.binding`), the engine the JAX package is held
  to.
* The fleet (`observe`, `pure_step`, `masked_reset`) against
  `JaxHanabiFleet` with injected decks, and its dimensions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu.envs.hanabi import jax_engine as je
from onpolicy_tpu.envs.hanabi.jax_fleet import JaxHanabiFleet

from onpolicy_torch.envs.hanabi import torch_engine as te
from onpolicy_torch.envs.hanabi.torch_fleet import TorchHanabiFleet

from test_jax_hanabi import CONFIGS, CppState, lib  # noqa: F401 (fixture)

torch.set_num_threads(1)
N_GAMES = 5


def _jax_fleet_fns(game):
    v = jax.vmap
    return {
        "reset": jax.jit(v(lambda d: je.reset_with_deck(game, d))),
        "step": jax.jit(v(lambda s, a: je.step(game, s, a))),
        "encode": jax.jit(v(lambda s, p: je.encode(game, s, p))),
        "own": jax.jit(v(lambda s, p: je.encode_own_hand(game, s, p))),
        "legal_for": jax.jit(v(lambda s, p: je.legal_mask_for(game, s, p))),
        "legal": jax.jit(v(lambda s: je.legal_mask(game, s))),
        "score": jax.jit(v(lambda s: je.score(game, s))),
    }


def _compare_states(jst, tst, where):
    for name, t in tst.tensors().items():
        j = np.asarray(getattr(jst, name))
        got = t.numpy()
        assert got.dtype == j.dtype, f"{where} {name}: {got.dtype} vs {j.dtype}"
        np.testing.assert_array_equal(got, j, err_msg=f"{where} {name}")


def _compare_views(game, fns, jst, tst, where):
    n = tst.deck.shape[0]
    for p in range(game.players):
        jp = jnp.full((n,), p, jnp.int32)
        tp = torch.full((n,), p, dtype=torch.int32)
        for fn, tfn in (("encode", te.encode), ("own", te.encode_own_hand),
                        ("legal_for", te.legal_mask_for)):
            want = np.asarray(fns[fn](jst, jp))
            got = tfn(game, tst, tp).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{where} {fn} p{p}")
    np.testing.assert_array_equal(te.legal_mask(game, tst).numpy(),
                                  np.asarray(fns["legal"](jst)),
                                  err_msg=f"{where} legal")
    np.testing.assert_array_equal(te.score(game, tst).numpy(),
                                  np.asarray(fns["score"](jst)),
                                  err_msg=f"{where} score")


def _moves(rng, legal: np.ndarray, n_moves: int) -> np.ndarray:
    """Per game: a legal move, a no-op (−1) or any move (often illegal)."""
    out = np.empty(len(legal), np.int32)
    for i, mask in enumerate(legal):
        u = rng.random()
        ok = np.flatnonzero(mask > 0)
        if u < 0.1:
            out[i] = -1
        elif u < 0.2 or ok.size == 0:
            out[i] = rng.integers(n_moves)
        else:
            out[i] = rng.choice(ok)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_lockstep_vs_jax(name):
    game_j = je.JaxHanabiGame.make(**CONFIGS[name])
    game = te.HanabiGame.make(**CONFIGS[name])
    assert (game.deck_len, game.n_moves, game.obs_dim, game.ownhand_dim) == (
        game_j.deck_len, game_j.n_moves, game_j.obs_dim, game_j.ownhand_dim)
    for a, b in zip(game.move_tables(), game_j.move_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(game.base_deck(), game_j.base_deck())
    fns = _jax_fleet_fns(game_j)
    rng = np.random.default_rng(sum(map(ord, name)))
    decks = np.stack([rng.permutation(game.base_deck())
                      for _ in range(N_GAMES)])
    jst = fns["reset"](jnp.asarray(decks))
    tst = te.reset_with_deck(game, torch.as_tensor(decks))
    _compare_states(jst, tst, f"{name} reset")
    _compare_views(game, fns, jst, tst, f"{name} reset")
    saw_terminal = False
    for move_i in range(140):
        legal = te.legal_mask(game, tst).numpy()
        uid = _moves(rng, legal, game.n_moves)
        jst, j_rew = fns["step"](jst, jnp.asarray(uid))
        tst, t_rew = te.step(game, tst, torch.as_tensor(uid))
        where = f"{name} move {move_i}"
        assert t_rew.dtype == torch.float32
        np.testing.assert_array_equal(t_rew.numpy(), np.asarray(j_rew),
                                      err_msg=f"{where} reward")
        _compare_states(jst, tst, where)
        _compare_views(game, fns, jst, tst, where)
        saw_terminal = saw_terminal or bool(tst.terminal.any())
        if bool(tst.terminal.all()):
            break
    assert saw_terminal


def test_engine_lockstep_vs_cpp(lib):  # noqa: F811 (fixture)
    """Two Hanabi-Full 3p games against the C++ engine, move by move."""
    cfg = CONFIGS["Full-3p"]
    game = te.HanabiGame.make(**cfg)
    game_j = je.JaxHanabiGame.make(**cfg)
    rng = np.random.default_rng(11)
    for g in range(2):
        deck = rng.permutation(game.base_deck())
        st = te.reset_with_deck(game, torch.as_tensor(deck[None]))
        cpp = CppState(lib, game_j, deck)
        for move_i in range(90):
            where = f"game {g} move {move_i}"
            assert int(st.cur_player[0]) == lib.hanabi_state_cur_player(cpp.h)
            assert bool(st.terminal[0]) == bool(lib.hanabi_state_terminal(cpp.h))
            assert int(te.score(game, st)[0]) == lib.hanabi_state_score(cpp.h)
            assert int(st.info[0]) == lib.hanabi_state_info_tokens(cpp.h)
            assert int(st.lives[0]) == lib.hanabi_state_life_tokens(cpp.h)
            assert game.deck_len - int(st.deck_ptr[0]) \
                == lib.hanabi_state_deck_size(cpp.h)
            for p in range(game.players):
                tp = torch.tensor([p])
                np.testing.assert_array_equal(
                    te.encode(game, st, tp)[0].numpy(), cpp.encode(p),
                    err_msg=f"{where} encode p{p}")
                np.testing.assert_array_equal(
                    te.encode_own_hand(game, st, tp)[0].numpy(),
                    cpp.encode_ownhand(p), err_msg=f"{where} own p{p}")
                np.testing.assert_array_equal(
                    te.legal_mask_for(game, st, tp)[0].numpy(),
                    cpp.legal_mask(p), err_msg=f"{where} legal p{p}")
            if bool(st.terminal[0]):
                break
            legal = np.flatnonzero(te.legal_mask(game, st)[0].numpy() > 0)
            uid = int(rng.choice(legal))
            assert lib.hanabi_state_legal(cpp.h, uid) == 1
            before = lib.hanabi_state_score(cpp.h)
            lib.hanabi_state_apply(cpp.h, uid)
            st, rew = te.step(game, st, torch.tensor([uid]))
            assert float(rew[0]) == float(lib.hanabi_state_score(cpp.h) - before)
        cpp.close()


def test_noop_and_illegal_are_ignored():
    game = te.HanabiGame.make(**CONFIGS["Small-2p"])
    g = torch.Generator().manual_seed(0)
    st = te.reset_with_deck(game, te.shuffled_decks(game, 3, g, "cpu"))
    # uid 0 = discard slot 0, illegal at max info tokens
    for uid in (-1, 0):
        st2, r = te.step(game, st, torch.full((3,), uid))
        assert not r.any()
        for k, v in st.tensors().items():
            assert torch.equal(v, getattr(st2, k)), (uid, k)


def _port_fleet(name, n, obs_instead=False):
    return TorchHanabiFleet(name, 2, n, torch.device("cpu"),
                            torch.Generator().manual_seed(0),
                            use_obs_instead_of_state=obs_instead)


@pytest.mark.parametrize("name, dims", [("Hanabi-Full", (660, 785, 20)),
                                        ("Hanabi-Small", (173, 193, 11))])
def test_fleet_dims(name, dims):
    fl = _port_fleet(name, 2)
    assert (fl.obs_dim, fl.share_dim, fl.n_moves) == dims
    jf = JaxHanabiFleet(name, 2, 2)
    assert (jf.obs_dim, jf.share_dim, jf.n_moves) == dims
    fo = _port_fleet(name, 2, obs_instead=True)
    assert fo.share_dim == JaxHanabiFleet(
        name, 2, 2, use_obs_instead_of_state=True).share_dim


@pytest.mark.parametrize("name, obs_instead", [("Hanabi-Small", False),
                                               ("Hanabi-Full", True)])
def test_fleet_against_jax(name, obs_instead):
    """observe / pure_step / masked_reset at N=6, the same decks injected
    into both (JAX's own draws are read out of its states)."""
    N = 6
    jf = JaxHanabiFleet(name, 2, N, use_obs_instead_of_state=obs_instead)
    tf = _port_fleet(name, N, obs_instead)
    j_observe, j_step, j_reset = (jax.jit(f) for f in (
        jf.observe, jf.pure_step, jf.masked_reset))
    jst = jax.jit(jf.reset_states)(jax.random.PRNGKey(0))
    tst = tf.reset_states(torch.tensor(np.asarray(jst.deck)))
    obs_names = ("obs", "share", "avail", "cur", "done", "score")

    def same(jout, tout, names, where):
        for n, j, t in zip(names, jout, tout):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{where} {n}")
    same(j_observe(jst), tf.observe(tst), obs_names, "reset")
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(5)
    saw_reset = False
    for t in range(60):
        avail = tf.observe(tst)[2].numpy()
        acts = np.array([rng.choice(np.flatnonzero(a)) if a.any() else -1
                         for a in avail])
        jout = j_step(jst, jnp.asarray(acts))
        tout = tf.pure_step(tst, torch.as_tensor(acts))
        same(jout[1:], tout[1:], ("obs", "share", "rewards", "done", "avail",
                                  "score"), f"step {t}")
        jst, tst = jout[0], tout[0]
        done = np.asarray(jout[4])
        if done.any():
            saw_reset = True
            key, k = jax.random.split(key)
            jst = j_reset(jst, jnp.asarray(done), k)
            tst = tf.masked_reset(tst, torch.as_tensor(done),
                                  torch.tensor(np.asarray(jst.deck)))
            _compare_states(jst, tst, f"reset after step {t}")
            same(j_observe(jst), tf.observe(tst), obs_names,
                 f"reset after step {t}")
    assert saw_reset


def test_fleet_protocol_and_shuffles():
    """The numpy protocol (reset / step) and the fleet's own decks: each a
    permutation of the base deck, drawn on the fleet's device."""
    fl = _port_fleet("Hanabi-Small", 8)
    obs, share, avail, cur = fl.reset()
    assert obs.shape == (8, fl.obs_dim) and share.shape == (8, fl.share_dim)
    decks = fl.states.deck.numpy()
    base = np.sort(fl.game.base_deck())
    assert all((np.sort(d) == base).all() for d in decks)
    assert len({d.tobytes() for d in decks}) > 1
    acts = np.array([np.flatnonzero(a)[0] for a in avail])
    obs2, share2, rewards, done, cur2, avail2, score = fl.step(acts)
    assert rewards.shape == (8, 2, 1) and done.dtype == bool
    assert (cur2 == 1).all()
    obs3, *_ = fl.reset(np.ones(8, bool))
    assert fl.states.deck_ptr.eq(4).all()
