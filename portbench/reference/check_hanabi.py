"""The comparison that decides `correct` for the Hanabi family.

The runner's buffer step is one seat round: seat m of game n acts in
round t where `active_masks[t, n, m]` is 1, on `obs[t, n, m]` (the
engine's encoding of the game for that seat and a one-hot of the seat),
with the legal moves `available_actions[t, n, m]`; its recurrent state
after the act lands in slot t+1. A game that ends in round t has
`masks[t+1, n]` 0 and restarts with a fresh deck after the round. The
first round of an episode acts before the update that the episode makes
on the previous episode's buffer, the others after it; slot 0 of a buffer
holds no recurrent state (the previous buffer's slot T does), and the
update reads the buffer with its last slot and its rewards taken from the
next episode's first round (the reference's deferred update).

The reference
  * deals each game again: its deck in draw order is read off the acting
    seats' views (`deal_order`): the first act shows both hands, the
    initial deal, and every card a seat draws shows at the end of its
    hand in the next seat's view; the cards no view shows fill the rest
    of the deck in a fixed order, and a game whose shown cards are not
    drawn from one deck is a mismatch;
  * replays every game from its deck and its served moves through two
    engines that share no code with the program's Python package: the
    plain tensor engine (`hanabi_engine`, a frozen copy of the device
    engine as it was when this benchmark was written) and the
    repository's C++ engine (`hanabi_cpp`, the engine of the host seat
    loop, built from its sources); at every act the seat, its
    observation, its centralized view and its legal moves must equal the
    engine's, and each game must end where the engine says it ends, bit
    for bit, on both engines;
  * recomputes the acting step with its own weights at the weights the
    act used, and checks that every served action was legal;
  * computes GAE with its own ValueNorm and runs the update itself.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import hanabi_cpp
from portbench.reference import hanabi_engine as he
from portbench.reference.side import Side, acting, update_gaps, widest


def _cards(block: np.ndarray, H: int, CR: int) -> np.ndarray:
    """[K, H·CR] one-hot hand -> [K, H] card ids (-1 where empty)."""
    oh = block.reshape(-1, H, CR)
    return np.where(oh.any(-1), oh.argmax(-1), -1)


def deal_order(game, bufs: list) -> dict:
    """Each game's deck in draw order, from the views of the buffers
    (consecutive episodes, the first from the run's start) -> "decks"
    [S, D] a game (segment) each, "bad" [S] (cards not from one deck),
    "ended" [S] (the game ended inside the buffers), and every act in
    time order: "j", "t", "n", "m", "seg", "uid" [A]; "starts" {(j, t,
    m): (rows, segments)} where a game starts."""
    P, H, D = game.players, game.hand_size, game.deck_len
    CR = game.colors * game.ranks
    own_w, deal = game.ownhand_dim, P * H
    hand = lambda o: slice(own_w + (o - 1) * H * CR, own_w + o * H * CR)
    left = slice(own_w + (P - 1) * H * CR + P,
                 own_w + (P - 1) * H * CR + P + D - deal)
    N = bufs[0]["actions"].shape[1]
    cap = N * (sum(b["actions"].shape[0] for b in bufs) + 1)
    decks = np.full((cap, D), -1, np.int16)
    ended = np.zeros(cap, bool)
    taken = np.zeros(cap, np.int64)
    cur = np.full(N, -1)
    drawn = np.zeros(N, np.int64)
    fresh = np.ones(N, bool)
    seen = np.zeros(N, np.int64)
    mover = np.zeros(N, np.int64)
    acts, starts, S = [], {}, 0
    for j, buf in enumerate(bufs):
        T, _, M = buf["actions"].shape[:3]
        act = (buf["active_masks"][:T, :, :, 0] > 0).numpy()
        over = (buf["masks"][1:T + 1, :, 0, 0] == 0).numpy()
        uid = buf["actions"][:T, :, :, 0].long().numpy()
        for t in range(T):
            for m in range(M):
                a = act[t, :, m]
                if not a.any():
                    continue
                view = buf["share_obs"][t, :, m].numpy()
                new = np.flatnonzero(a & fresh)
                if len(new):
                    sids = S + np.arange(len(new))
                    S += len(new)
                    starts[(j, t, m)] = (new, sids)
                    cur[new], fresh[new], drawn[new] = sids, False, deal
                    taken[sids] = deal
                    for p in range(P):
                        o = (p - m) % P
                        cards = (view[new, :own_w] if o == 0
                                 else view[new, hand(o)])
                        decks[sids, p * H:(p + 1) * H] = _cards(cards, H, CR)
                rows = np.flatnonzero(a)
                count = view[rows, left].sum(-1).astype(np.int64)
                old = np.isin(rows, new, invert=True)
                drew = rows[old & (count == seen[rows] - 1)]
                if len(drew):
                    # the last mover's hand, its drawn card at the end
                    o = (mover[drew] - m) % P
                    for k in np.unique(o):
                        r = drew[o == k]
                        # a game that draws past its deck is not one deck
                        taken[cur[r[drawn[r] >= D]]] = D + 1
                        r = r[drawn[r] < D]
                        card = _cards(view[r, hand(k)], H, CR)[:, H - 1]
                        decks[cur[r], drawn[r]] = card
                        drawn[r] += 1
                        taken[cur[r]] = drawn[r]
                seen[rows], mover[rows] = count, m
                acts.append((np.full(len(rows), j), np.full(len(rows), t),
                             rows, np.full(len(rows), m), cur[rows],
                             uid[t, rows, m]))
            done = np.flatnonzero(over[t] & ~fresh)
            ended[cur[done]] = True
            fresh[done] = True
    decks, ended, taken = decks[:S], ended[:S], taken[:S]
    base = np.bincount(game.base_deck().astype(np.int64), minlength=CR)
    bad = np.zeros(S, bool)
    for s in range(S):
        k = min(taken[s], D)
        row = decks[s, :k].astype(np.int64)
        have = np.bincount(row[row >= 0], minlength=CR)
        bad[s] = bool(taken[s] > D or (row < 0).any()
                      or (have > base).any())
        rest = np.repeat(np.arange(CR), np.clip(base - have, 0, None))
        decks[s, :k] = np.maximum(row, 0)
        decks[s, k:] = np.resize(rest if len(rest) else [0], D - k)
    cols = [np.concatenate(c) for c in zip(*acts)]
    return {"decks": decks.astype(np.int8), "bad": bad, "ended": ended,
            "starts": starts,
            **dict(zip(("j", "t", "n", "m", "seg", "uid"), cols))}


def _view(game, S, seat, M):
    """The tensor engine's view for `seat` [N]: (obs, share, legal)."""
    enc = he.encode(game, S, seat)
    turn = torch.nn.functional.one_hot(seat.long(), M).float()
    own = he.encode_own_hand(game, S, seat)
    return (torch.cat([enc, turn], -1), torch.cat([own, enc, turn], -1),
            he.legal_mask_for(game, S, seat))


def replay_tensor(game, buf: dict, j: int, order: dict, S, device) -> tuple:
    """Buffer j's rounds on the plain tensor engine, carrying S (None
    before the first buffer) -> (S, mismatching acts and game ends)."""
    T, N, M = buf["actions"].shape[:3]
    act = buf["active_masks"][:T, :, :, 0] > 0
    over = buf["masks"][1:T + 1, :, 0, 0] == 0
    decks = torch.as_tensor(order["decks"], device=device)
    bad = torch.zeros((), dtype=torch.long, device=device)
    for t in range(T):
        for m in range(M):
            if (j, t, m) in order["starts"]:
                rows, sids = (torch.as_tensor(x, device=device)
                              for x in order["starts"][(j, t, m)])
                deck = torch.zeros(N, game.deck_len, dtype=torch.int8,
                                   device=device)
                deck[rows] = decks[sids]
                new = he.reset_with_deck(game, deck)
                if S is None:
                    S = new
                else:
                    mask = torch.zeros(N, dtype=torch.bool, device=device)
                    mask[rows] = True
                    S = new.where(mask, S)
            if S is None:
                continue
            seat = torch.full((N,), m, dtype=torch.int32, device=device)
            obs, share, legal = _view(game, S, seat, M)
            differ = ((obs != buf["obs"][t, :, m]).any(-1)
                      | (share != buf["share_obs"][t, :, m]).any(-1)
                      | (legal != buf["available_actions"][t, :, m]).any(-1)
                      | (S.cur_player != m))
            bad += (differ & act[t, :, m]).sum()
            uid = torch.where(act[t, :, m], buf["actions"][t, :, m, 0].long(),
                              -1)
            S, _ = he.step(game, S, uid)
        if S is not None:
            bad += (S.terminal != over[t]).sum()
    return S, bad


def replay_cpp(game, bufs: list, order: dict, chunk: int = 65536) -> int:
    """Every game on the C++ engine -> mismatching acts and game ends."""
    by_game = np.argsort(order["seg"], kind="stable")
    out = hanabi_cpp.replay(game, order["decks"].astype(np.int64),
                            order["seg"][by_game], order["m"][by_game],
                            order["uid"][by_game])
    bad = int((out["terminal"] != order["ended"]).sum())
    M = bufs[0]["actions"].shape[2]
    for lo in range(0, len(by_game), chunk):
        part = np.arange(lo, min(lo + chunk, len(by_game)))
        a = by_game[part]
        for j, buf in enumerate(bufs):
            here = order["j"][a] == j
            if not here.any():
                continue
            t, n, m = (order[k][a[here]] for k in ("t", "n", "m"))
            at = part[here]
            turn = np.eye(M, dtype=np.float32)[m]
            want_obs = np.concatenate([out["obs"][at], turn], -1)
            want_share = np.concatenate([out["own"][at], out["obs"][at],
                                         turn], -1)
            differ = ((buf["obs"][t, n, m].numpy() != want_obs).any(-1)
                      | (buf["share_obs"][t, n, m].numpy()
                         != want_share).any(-1)
                      | (buf["available_actions"][t, n, m].numpy()
                         != out["legal"][at]).any(-1)
                      | (out["cur"][at] != m))
            bad += int(differ.sum())
    return bad


def _act_rows(buf: dict, prev: dict) -> tuple:
    """Every act of a buffer as flat rows, the first round apart (it acted
    with the weights from before the episode's update) -> (first round's
    rows, the others', the rows' [T, N, M] mask of acts)."""
    T, N, M = buf["actions"].shape[:3]
    h, hc, mask = buf["rnn_states"], buf["rnn_states_critic"], buf["masks"]
    if prev is None:
        h0, hc0, m0 = (torch.zeros_like(h[0]), torch.zeros_like(hc[0]),
                       torch.ones_like(mask[0]))
    else:
        h0, hc0, m0 = (prev["rnn_states"][T], prev["rnn_states_critic"][T],
                       prev["masks"][T])
    h_in = torch.cat([h0[None], h[1:T]])
    hc_in = torch.cat([hc0[None], hc[1:T]])
    m_in = torch.cat([m0[None], mask[1:T]])
    act = buf["active_masks"][:T, ..., 0] > 0
    fields = {"obs": buf["obs"][:T], "share_obs": buf["share_obs"][:T],
              "avail": buf["available_actions"][:T], "h_in": h_in,
              "hc_in": hc_in, "mask": m_in, "action": buf["actions"]}
    first = {k: v[0][act[0]] for k, v in fields.items()}
    rest = {k: v[1:][act[1:]] for k, v in fields.items()}
    return first, rest, act


def _acting(side: Side, buf: dict, prev: dict) -> dict:
    """The reference's acting step over every act of a buffer, in the
    buffer's [T, N, M, ...] layout (zeros where no act)."""
    first, rest, act = _act_rows(buf, prev)
    a = side.act(first, "previous")
    b = side.act(rest, "current")
    out = {}
    for k in a:
        full = torch.zeros(*act.shape, *a[k].shape[1:], device=a[k].device)
        full[0][act[0]] = a[k]
        full[1:][act[1:]] = b[k]
        out[k] = full
    return out


def _batch(side: Side, buf: dict, patch: dict, acted: dict) -> dict:
    """The update's batch: the buffer with its tail slot and rewards from
    the next episode's first round, the reference's own values and
    log-probabilities at the acts."""
    T = buf["actions"].shape[0]
    act = buf["active_masks"][:T] > 0
    tail = lambda k: torch.cat([buf[k][:T], patch[k][None]])
    share = tail("share_obs")
    N, M = share.shape[1:3]
    flat = lambda x: x.reshape(N * M, *x.shape[2:])
    boot = side.value(flat(share[T]), flat(buf["rnn_states_critic"][T]),
                      flat(buf["masks"][T])).reshape(N, M, 1)
    values = torch.where(act, acted["value"], buf["value_preds"][:T])
    rewards = torch.cat([buf["rewards"][1:T], patch["rewards"][None]])
    ret, adv = side.returns(rewards, torch.cat([values, boot[None]]),
                            buf["masks"])
    return {"obs": buf["obs"][:T], "share_obs": buf["share_obs"][:T],
            "actions": buf["actions"],
            "old_logp": torch.where(act, acted["logp"],
                                    buf["action_log_probs"]),
            "value_preds": values, "returns": ret, "advantages": adv,
            "masks": buf["masks"][:T], "active": buf["active_masks"][:T],
            "avail": buf["available_actions"][:T],
            "rnn_actor": buf["rnn_states"][:T],
            "rnn_critic": buf["rnn_states_critic"][:T]}


def check(cap: dict, config: dict, device, control: bool = False) -> dict:
    """-> the compared numbers. With `control` the reference in TF32 takes
    the program's place."""
    hp = {**config["model"], **config["ppo"]}
    game = he.HanabiGame.make(**config["game"])
    ref = Side(hp, cap["weights"], device)
    other = Side(hp, cap["weights"], device, tf32=True) if control else None
    bufs = cap["buffers"]
    order = deal_order(game, bufs)
    r = {"engine_mismatches": int(order["bad"].sum())
         + replay_cpp(game, bufs, order),
         "illegal_actions": 0, "games_replayed": len(order["decks"]),
         "acts": 0, "act_gaps": []}
    dev = lambda d: {k: v.to(device) for k, v in d.items()}
    prev, S = None, None
    for j, host_buf in enumerate(bufs):
        buf = dev(host_buf)
        T = buf["actions"].shape[0]
        S, bad = replay_tensor(game, buf, j, order, S, device)
        r["engine_mismatches"] += int(bad)
        act = buf["active_masks"][:T] > 0
        r["acts"] += int(act.sum())
        legal = buf["available_actions"][:T].gather(
            -1, buf["actions"].long())
        r["illegal_actions"] += int(((legal == 0) & act).sum())
        want = _acting(ref, buf, prev)
        if control:
            got = _acting(other, buf, prev)
        else:
            got = {"logp": buf["action_log_probs"],
                   "value": buf["value_preds"][:T],
                   "h_out": buf["rnn_states"][1:T + 1],
                   "hc_out": buf["rnn_states_critic"][1:T + 1]}
        goes_on = act & (buf["masks"][1:T + 1] > 0)
        r["act_gaps"].append(max(
            widest(got["logp"], want["logp"], act),
            widest(got["value"], want["value"], act),
            widest(got["h_out"], want["h_out"], goes_on[..., None]),
            widest(got["hc_out"], want["hc_out"], goes_on[..., None])))
        patch = dev(bufs[j + 1] if j + 1 < len(bufs) else cap["patch_last"])
        if j + 1 < len(bufs):
            patch = {k: patch[k][0] for k in cap["patch_last"]}
        ref.train(_batch(ref, buf, patch, want))
        if control:
            other.train(_batch(other, buf, patch, got))
        prev = {k: buf[k] for k in ("rnn_states", "rnn_states_critic",
                                    "masks")}
        del buf, want, got
    r.update(acting(r["act_gaps"]), **update_gaps(hp, cap, ref, other))
    return r
