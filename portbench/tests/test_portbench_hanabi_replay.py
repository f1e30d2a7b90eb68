"""The Hanabi engine check without the program: buffers laid out as the
runner writes them are made here from the plain tensor engine under a
policy that mixes hints, plays and discards (decks run out, final rounds
happen); the decks read off the views and both replays find nothing, and
one changed bit, one game left standing, or one card dealt twice is
found.

    python -m pytest portbench/tests -q
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.reference import check_hanabi as ch  # noqa: E402
from portbench.reference import hanabi_engine as he  # noqa: E402

GAME = he.HanabiGame.make(colors=5, ranks=5, players=2, hand_size=5)


def buffers(n=48, T=60, episodes=2, seed=3, stale=None):
    """`episodes` consecutive buffers of n games from a fresh deal; with
    `stale` = game g, that game's engine never moves."""
    g = torch.Generator().manual_seed(seed)
    M, A = GAME.players, GAME.n_moves
    S = he.reset_with_deck(GAME, he.shuffled_decks(GAME, n, g, "cpu"))
    out = []
    for _ in range(episodes):
        z = lambda *s: torch.zeros(*s)
        b = {"obs": z(T + 1, n, M, GAME.obs_dim + M),
             "share_obs": z(T + 1, n, M, GAME.ownhand_dim + GAME.obs_dim + M),
             "available_actions": z(T + 1, n, M, A),
             "actions": z(T, n, M, 1), "active_masks": z(T + 1, n, M, 1),
             "masks": torch.ones(T + 1, n, M, 1)}
        for t in range(T):
            ended = torch.zeros(n, dtype=torch.bool)
            for m in range(M):
                seat = torch.full((n,), m, dtype=torch.int32)
                obs, share, legal = ch._view(GAME, S, seat, M)
                act = (S.cur_player == m) & ~S.terminal
                # hints and discards, few plays: most decks run out
                w = legal * torch.tensor([3.0] * 5 + [0.1] * 5 + [2.0] * 10)
                uid = torch.multinomial(w + 1e-9, 1, generator=g)[:, 0]
                uid = torch.where(act, uid, -1)
                b["obs"][t, :, m][act] = obs[act]
                b["share_obs"][t, :, m][act] = share[act]
                b["available_actions"][t, :, m][act] = legal[act]
                b["actions"][t, :, m, 0] = uid.float().clamp(min=0)
                b["active_masks"][t, :, m, 0] = act.float()
                S2, _ = he.step(GAME, S, uid)
                if stale is not None:
                    keep = torch.zeros(n, dtype=torch.bool)
                    keep[stale] = True
                    S2 = S.where(keep, S2)
                S = S2
                ended |= act & S.terminal
            b["masks"][t + 1][ended] = 0.0
            fresh = he.reset_with_deck(GAME, he.shuffled_decks(GAME, n, g,
                                                               "cpu"))
            S = fresh.where(S.terminal, S)
        out.append(b)
    return out


def mismatches(bufs) -> int:
    order = ch.deal_order(GAME, bufs)
    bad = int(order["bad"].sum()) + ch.replay_cpp(GAME, bufs, order)
    S = None
    for j, b in enumerate(bufs):
        S, k = ch.replay_tensor(GAME, b, j, order, S, "cpu")
        bad += int(k)
    return bad


def test_sound_games_replay_without_a_mismatch():
    bufs = buffers()
    order = ch.deal_order(GAME, bufs)
    acts = sum(int(b["active_masks"].sum()) for b in bufs)
    assert len(order["seg"]) == acts
    # games that ran their deck out, and games that ended inside the
    # buffers, are among them
    left = GAME.ownhand_dim + (GAME.players - 1) * GAME.ownhand_dim \
        + GAME.players
    empty = [(b["share_obs"][..., left:left + 40].sum(-1) == 0)
             & (b["active_masks"][..., 0] > 0) for b in bufs]
    assert any(bool(e.any()) for e in empty)
    assert order["ended"].sum() >= 10
    assert mismatches(bufs) == 0


def test_one_changed_bit_is_found_by_both_engines():
    bufs = buffers()
    act = (bufs[1]["active_masks"][..., 0] > 0).nonzero()[100]
    t, n, m = act.tolist()
    bufs[1]["obs"][t, n, m, 200] = 1 - bufs[1]["obs"][t, n, m, 200]
    order = ch.deal_order(GAME, bufs)
    assert ch.replay_cpp(GAME, bufs, order) == 1
    S, _ = ch.replay_tensor(GAME, bufs[0], 0, order, None, "cpu")
    assert int(ch.replay_tensor(GAME, bufs[1], 1, order, S, "cpu")[1]) == 1


def test_a_game_left_standing_is_found():
    assert mismatches(buffers(stale=5)) > 0


def test_a_card_dealt_twice_is_found():
    bufs = buffers()
    # the first act of game 0 shows its partner holding five red ones
    card = torch.zeros(GAME.colors * GAME.ranks)
    card[0] = 1.0
    view = bufs[0]["share_obs"][0, 0, 0]
    view[GAME.ownhand_dim:2 * GAME.ownhand_dim] = card.repeat(GAME.hand_size)
    order = ch.deal_order(GAME, bufs)
    assert order["bad"][order["seg"][(order["n"] == 0)][0]]
