"""Device-resident Hanabi: the game engine as batched PyTorch functions.

Port of `onpolicy_tpu/envs/hanabi/jax_engine.py`, whose semantics are the
C++ engine's (`cpp/hanabi/hanabi.{h,cc}`), itself bit-exact against the
reference's HLE fork. The JAX engine runs one game and is vmapped; here
every function takes a fleet of N games at once, each field of the state
with a leading [N] axis. The JAX engine's one-hot select/update helpers
(`_sel`, `_sel_rows`, `_set_row`) are TPU tuning against gather/scatter
cost; here the same reads and writes are indexing.

State (`HanabiState`, one tensor per field, leading axis N):
  deck        [N, deck_len] int8 card ids (color·R + rank) in DRAW order
  deck_ptr    [N] int32: next card to draw
  hand_card   [N, P, H] int8 (−1 = empty); hand_n [N, P] int32
  know_color / know_rank [N, P, H] int32 plausibility bitmasks
  hinted_color / hinted_rank [N, P, H] int32 (−1 = none)
  fireworks   [N, C] int32; info / lives [N] int32
  discards    [N, C, R] int32 copy counts
  last_*      [N] mirroring C++ LastAction
  cur_player, final_countdown [N] int32; terminal [N] bool

Hands replicate the C++ erase-slot-then-append-draw exactly (slots shift
left, the drawn card lands at the new end). Results are bit-exact with
the JAX engine: the same integer fields, and 0/1 float32 encodings.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

RANK_COUNTS = (3, 2, 2, 2, 1)    # copies of each rank per color


def rank_count(rank: int) -> int:
    return RANK_COUNTS[rank]


def cards_per_color(ranks: int) -> int:
    return sum(RANK_COUNTS[:ranks])


# Move-type codes (C++ MoveType order; the encoder uses the one-hot order
# play, discard, reveal-color, reveal-rank)
DISCARD, PLAY, REVEAL_COLOR, REVEAL_RANK = 0, 1, 2, 3


@dataclass(frozen=True)
class HanabiGame:
    """Hashable static game description and its derived move tables."""
    colors: int = 5
    ranks: int = 5
    players: int = 2
    hand_size: int = 5
    max_info: int = 8
    max_life: int = 3
    minimal: bool = False

    @classmethod
    def make(cls, colors=5, ranks=5, players=2, hand_size=-1, max_info=8,
             max_life=3, minimal=False):
        if hand_size is None or hand_size <= 0:
            hand_size = 5 if players < 4 else 4
        return cls(colors, ranks, players, hand_size, max_info, max_life,
                   minimal)

    @property
    def deck_len(self) -> int:
        return self.colors * cards_per_color(self.ranks)

    @property
    def n_moves(self) -> int:
        return 2 * self.hand_size + (self.players - 1) * (self.colors
                                                          + self.ranks)

    @property
    def obs_dim(self) -> int:
        C, R, P, H = self.colors, self.ranks, self.players, self.hand_size
        hands = (P - 1) * H * C * R + P
        board = (self.deck_len - P * H) + C * R + self.max_info \
            + self.max_life
        discards = C * cards_per_color(R)
        last = P + 4 + P + C + R + H + H + C * R + 2
        knowledge = 0 if self.minimal else P * H * (C * R + C + R)
        return hands + board + discards + last + knowledge

    @property
    def ownhand_dim(self) -> int:
        return self.hand_size * self.colors * self.ranks

    def move_tables(self):
        """uid → (type, slot, target offset, color, rank), C++
        Game::GetMove; each an int32 numpy array of n_moves."""
        C, R, P, H = self.colors, self.ranks, self.players, self.hand_size
        rows = []
        for uid in range(self.n_moves):
            if uid < H:
                rows.append((DISCARD, uid, 0, -1, -1))
            elif uid < 2 * H:
                rows.append((PLAY, uid - H, 0, -1, -1))
            elif uid < 2 * H + (P - 1) * C:
                k = uid - 2 * H
                rows.append((REVEAL_COLOR, -1, 1 + k // C, k % C, -1))
            else:
                k = uid - 2 * H - (P - 1) * C
                rows.append((REVEAL_RANK, -1, 1 + k // R, -1, k % R))
        return tuple(np.asarray(col, np.int32) for col in zip(*rows))

    def base_deck(self) -> np.ndarray:
        """Card ids of the full multiset, in C++ Reset composition order."""
        ids = []
        for c in range(self.colors):
            for r in range(self.ranks):
                ids.extend([c * self.ranks + r] * rank_count(r))
        return np.asarray(ids, np.int8)


@functools.lru_cache(maxsize=None)
def _tables(game: HanabiGame, device: torch.device) -> dict:
    """The game's constant tensors on `device`: move tables, the base
    deck, and the index tables of `encode` (discards section, last move's
    type). The step and observation chains read their constants only
    from here, so that they copy nothing from the host (a CUDA graph
    captures them)."""
    mtype, slot, target, color, rank = (
        torch.as_tensor(t, dtype=torch.long, device=device)
        for t in game.move_tables())
    # discard thermometer bits in (color, rank, copy) order
    dc, dr, dj = zip(*[(c, r, j) for c in range(game.colors)
                       for r in range(game.ranks)
                       for j in range(rank_count(r))])
    as_long = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
    return {"mtype": mtype, "slot": slot, "target": target, "color": color,
            "rank": rank,
            "base_deck": torch.as_tensor(game.base_deck(), device=device),
            "disc_c": as_long(dc), "disc_r": as_long(dr), "disc_j": as_long(dj),
            "rank_counts": as_long(RANK_COUNTS[:game.ranks]).int(),
            # the encoder's one-hot position of each move-type code:
            # play, discard, reveal-color, reveal-rank
            "type_order": as_long([1, 0, 2, 3])}


@dataclass
class HanabiState:
    deck: torch.Tensor
    deck_ptr: torch.Tensor
    hand_card: torch.Tensor
    hand_n: torch.Tensor
    know_color: torch.Tensor
    know_rank: torch.Tensor
    hinted_color: torch.Tensor
    hinted_rank: torch.Tensor
    fireworks: torch.Tensor
    info: torch.Tensor
    lives: torch.Tensor
    discards: torch.Tensor
    last_acting: torch.Tensor       # −1 = none yet
    last_type: torch.Tensor         # move-type code, −1 = none
    last_target: torch.Tensor
    last_color: torch.Tensor
    last_rank: torch.Tensor
    last_reveal: torch.Tensor       # slot bitmask
    last_slot: torch.Tensor
    last_card: torch.Tensor         # card id, −1 = none
    last_success: torch.Tensor      # bool
    last_added_info: torch.Tensor   # bool
    cur_player: torch.Tensor
    final_countdown: torch.Tensor
    terminal: torch.Tensor

    def replace(self, **kw) -> "HanabiState":
        return dataclasses.replace(self, **kw)

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def where(self, mask: torch.Tensor, other: "HanabiState") -> "HanabiState":
        """Per game: this state where `mask` [N], else `other`."""
        def pick(a, b):
            return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)
        return HanabiState(**{k: pick(v, getattr(other, k))
                              for k, v in self.tensors().items()})


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=dtype, device=device)


def reset_with_deck(game: HanabiGame, deck: torch.Tensor) -> HanabiState:
    """Fresh games from `deck` [N, deck_len], each row the DRAW order (card
    ids), as C++ ResetWithDeck; the initial deal is player-major,
    slot-minor (DealInitialHands)."""
    P, H, C, R = game.players, game.hand_size, game.colors, game.ranks
    N, dev = deck.shape[0], deck.device
    i32 = torch.int32
    deck = deck.to(torch.int8)
    know = lambda bits: torch.full((N, P, H), (1 << bits) - 1, dtype=i32,
                                   device=dev)
    none = lambda: _full(N, -1, i32, dev)
    return HanabiState(
        deck=deck,
        deck_ptr=_full(N, P * H, i32, dev),
        hand_card=deck[:, :P * H].reshape(N, P, H).clone(),
        hand_n=torch.full((N, P), H, dtype=i32, device=dev),
        know_color=know(C), know_rank=know(R),
        hinted_color=torch.full((N, P, H), -1, dtype=i32, device=dev),
        hinted_rank=torch.full((N, P, H), -1, dtype=i32, device=dev),
        fireworks=torch.zeros((N, C), dtype=i32, device=dev),
        info=_full(N, game.max_info, i32, dev),
        lives=_full(N, game.max_life, i32, dev),
        discards=torch.zeros((N, C, R), dtype=i32, device=dev),
        last_acting=none(), last_type=none(), last_target=none(),
        last_color=none(), last_rank=none(), last_reveal=_full(N, 0, i32, dev),
        last_slot=none(), last_card=none(),
        last_success=_full(N, False, torch.bool, dev),
        last_added_info=_full(N, False, torch.bool, dev),
        cur_player=_full(N, 0, i32, dev),
        final_countdown=_full(N, P, i32, dev),
        terminal=_full(N, False, torch.bool, dev),
    )


def shuffled_decks(game: HanabiGame, n: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    """[n, deck_len] int8: n uniform shuffles of the base deck, drawn from
    `generator` (on `device`)."""
    base = _tables(game, torch.device(device))["base_deck"]
    keys = torch.rand(n, game.deck_len, generator=generator, device=device)
    return base[keys.argsort(dim=1)]


def score(game: HanabiGame, s: HanabiState) -> torch.Tensor:
    """[N] int32: the fireworks' sum, 0 once the lives are gone."""
    total = s.fireworks.sum(1, dtype=torch.int32)
    return torch.where(s.lives <= 0, torch.zeros_like(total), total)


def _row(x: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """x[n, player[n]] for a per-player field x [N, P, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), player.long()]


def legal_mask(game: HanabiGame, s: HanabiState) -> torch.Tensor:
    """[N, n_moves] float32 mask of the legal moves of the CURRENT player
    (zeros when terminal): C++ LegalMovesMask(cur_player)."""
    t = _tables(game, s.deck.device)
    P, H, R = game.players, game.hand_size, game.ranks
    N = s.deck.shape[0]
    ar = torch.arange(N, device=s.deck.device)
    cur = s.cur_player.long()
    hand_n_cur = s.hand_n[ar, cur][:, None]                   # [N, 1]
    slot = t["slot"][None]
    ok_discard = (slot < hand_n_cur) & (s.info[:, None] < game.max_info)
    ok_play = slot < hand_n_cur
    tgt = (cur[:, None] + t["target"][None]) % P               # [N, A]
    tgt_cards = s.hand_card[ar[:, None], tgt].long()           # [N, A, H]
    valid_slot = torch.arange(H, device=s.deck.device) \
        < s.hand_n[ar[:, None], tgt][..., None]
    has_color = (valid_slot & (tgt_cards // R == t["color"][None, :, None])
                 ).any(-1)
    has_rank = (valid_slot & (tgt_cards % R == t["rank"][None, :, None])
                ).any(-1)
    info_left = (s.info > 0)[:, None]
    mtype = t["mtype"][None]
    ok = torch.where(mtype == DISCARD, ok_discard,
                     torch.where(mtype == PLAY, ok_play,
                                 torch.where(mtype == REVEAL_COLOR,
                                             info_left & has_color,
                                             info_left & has_rank)))
    return torch.where(s.terminal[:, None], 0.0, ok.float())


def legal_mask_for(game: HanabiGame, s: HanabiState, player: torch.Tensor
                   ) -> torch.Tensor:
    """LegalMovesMask(player) [N, n_moves]: zeros unless it is `player`'s
    turn."""
    mask = legal_mask(game, s)
    turn = (player.long() == s.cur_player.long()) & ~s.terminal
    return torch.where(turn[:, None], mask, torch.zeros_like(mask))


def _remove_and_draw(game: HanabiGame, s: HanabiState, p: torch.Tensor,
                     slot_idx: torch.Tensor) -> HanabiState:
    """Erase `slot_idx` from player p's hand and knowledge, then draw (C++
    erase + Draw): slots above shift left; the drawn card lands at the new
    end. p, slot_idx [N]."""
    H, C, R, D = game.hand_size, game.colors, game.ranks, game.deck_len
    N, dev = s.deck.shape[0], s.deck.device
    ar = torch.arange(N, device=dev)
    p = p.long()
    n = s.hand_n[ar, p]                                        # [N]
    idx = torch.arange(H, device=dev)
    nxt = torch.clamp(idx + 1, max=H - 1)
    can_draw = s.deck_ptr < D
    drawn = torch.where(
        can_draw, s.deck[ar, torch.clamp(s.deck_ptr, max=D - 1).long()].int(),
        -1)
    new_n = n - 1 + can_draw.int()
    end = n - 1                 # where the drawn card lands (hand had n)
    shifted = idx[None] >= slot_idx[:, None]
    at_end = idx[None] == end[:, None]
    beyond = idx[None] >= new_n[:, None]

    def place(row, value, fill):
        row = torch.where(shifted, row[:, nxt], row)
        row = torch.where(at_end, torch.where(can_draw, value, fill)[:, None],
                          row)
        return torch.where(beyond, fill, row)

    def put(field, new_row):
        out = field.clone()
        out[ar, p] = new_row.to(field.dtype)
        return out

    full_c, full_r = (1 << C) - 1, (1 << R) - 1
    hand_n = s.hand_n.clone()
    hand_n[ar, p] = new_n
    return s.replace(
        hand_card=put(s.hand_card,
                      place(s.hand_card[ar, p].int(), drawn, -1)),
        hand_n=hand_n,
        know_color=put(s.know_color, place(s.know_color[ar, p],
                                           full_c, full_c)),
        know_rank=put(s.know_rank, place(s.know_rank[ar, p], full_r, full_r)),
        hinted_color=put(s.hinted_color, place(s.hinted_color[ar, p], -1, -1)),
        hinted_rank=put(s.hinted_rank, place(s.hinted_rank[ar, p], -1, -1)),
        deck_ptr=s.deck_ptr + can_draw.int())


def step(game: HanabiGame, s: HanabiState, uid: torch.Tensor
         ) -> Tuple[HanabiState, torch.Tensor]:
    """BatchedHanabi::Step for each game: apply uid [N] iff uid ≥ 0, the
    game is not over, and the move is legal. Returns (state, reward [N]
    float32 = score delta)."""
    t = _tables(game, s.deck.device)
    C, R, P, H = game.colors, game.ranks, game.players, game.hand_size
    N, dev = s.deck.shape[0], s.deck.device
    ar = torch.arange(N, device=dev)
    i32 = torch.int32
    uid = uid.long()
    uid_c = torch.clamp(uid, 0, game.n_moves - 1)
    legal = legal_mask(game, s)[ar, uid_c] > 0
    do = (uid >= 0) & ~s.terminal & legal
    before = score(game, s)

    mtype = t["mtype"][uid_c]
    slot = t["slot"][uid_c]
    color = t["color"][uid_c]
    rank = t["rank"][uid_c]
    cur = s.cur_player.long()
    tgt = (cur + t["target"][uid_c]) % P

    # final_countdown decrements at move ENTRY while the deck is empty
    deck_empty = s.deck_ptr >= game.deck_len
    countdown = s.final_countdown - (do & deck_empty).int()

    card = s.hand_card[ar, cur, torch.clamp(slot, 0, H - 1)].long()
    c_col, c_rank = card // R, card % R

    is_discard = do & (mtype == DISCARD)
    is_play = do & (mtype == PLAY)
    is_reveal_c = do & (mtype == REVEAL_COLOR)
    is_reveal_r = do & (mtype == REVEAL_RANK)
    is_cardmove = is_discard | is_play

    # ---- play resolution ---------------------------------------------
    col_c = torch.clamp(c_col, 0, C - 1)
    oh_col = torch.arange(C, device=dev)[None] == col_c[:, None]       # [N, C]
    oh_rank = torch.arange(R, device=dev)[None] \
        == torch.clamp(c_rank, 0, R - 1)[:, None]                       # [N, R]
    fw_at_col = s.fireworks[ar, col_c].long()
    success = is_play & (fw_at_col == c_rank)
    top_bonus = success & (c_rank == R - 1) & (s.info < game.max_info)
    misplay = is_play & ~success

    fireworks = s.fireworks + (success[:, None] & oh_col).int()
    discards = s.discards + ((is_discard | misplay)[:, None, None]
                             & oh_col[:, :, None] & oh_rank[:, None, :]).int()
    info = (s.info + is_discard.int() + top_bonus.int()
            - (is_reveal_c | is_reveal_r).int())
    lives = s.lives - misplay.int()

    # ---- hand update for card moves ----------------------------------
    s2 = _remove_and_draw(game, s, cur, slot).where(is_cardmove, s)

    # ---- hint knowledge updates --------------------------------------
    slots = torch.arange(H, device=dev)
    valid_t = slots[None] < s.hand_n[ar, tgt][:, None]
    t_cards = s.hand_card[ar, tgt].long()
    match_c = valid_t & (t_cards // R == color[:, None])
    match_r = valid_t & (t_cards % R == rank[:, None])
    bit_c = (1 << torch.clamp(color, 0, C - 1)).int()[:, None]
    bit_r = (1 << torch.clamp(rank, 0, R - 1)).int()[:, None]
    kc_row = s.know_color[ar, tgt]
    kc_new = torch.where(valid_t, torch.where(match_c, bit_c, kc_row & ~bit_c),
                         kc_row)
    kr_row = s.know_rank[ar, tgt]
    kr_new = torch.where(valid_t, torch.where(match_r, bit_r, kr_row & ~bit_r),
                         kr_row)
    hc_new = torch.where(match_c, color.int()[:, None], s.hinted_color[ar, tgt])
    hr_new = torch.where(match_r, rank.int()[:, None], s.hinted_rank[ar, tgt])

    def set_tgt(field, new_row, when):
        out = field.clone()
        out[ar, tgt] = torch.where(when[:, None], new_row, field[ar, tgt])
        return out

    weights = (1 << slots).int()[None]
    reveal_mask = torch.where(
        is_reveal_c, (match_c.int() * weights).sum(1, dtype=i32),
        torch.where(is_reveal_r, (match_r.int() * weights).sum(1, dtype=i32),
                    0))

    # ---- last-action record (unchanged on a no-op) -------------------
    upd = lambda new, old: torch.where(do, new.to(old.dtype), old)
    is_reveal = is_reveal_c | is_reveal_r
    s3 = s2.replace(
        know_color=set_tgt(s2.know_color, kc_new, is_reveal_c),
        hinted_color=set_tgt(s2.hinted_color, hc_new, is_reveal_c),
        know_rank=set_tgt(s2.know_rank, kr_new, is_reveal_r),
        hinted_rank=set_tgt(s2.hinted_rank, hr_new, is_reveal_r),
        fireworks=torch.where(do[:, None], fireworks, s.fireworks),
        discards=torch.where(do[:, None, None], discards, s.discards),
        info=upd(info, s.info), lives=upd(lives, s.lives),
        last_acting=upd(cur, s.last_acting),
        last_type=upd(mtype, s.last_type),
        last_target=upd(torch.where(is_reveal, tgt, -1), s.last_target),
        last_color=upd(torch.where(is_reveal_c, color, -1), s.last_color),
        last_rank=upd(torch.where(is_reveal_r, rank, -1), s.last_rank),
        last_reveal=upd(reveal_mask, s.last_reveal),
        last_slot=upd(torch.where(is_cardmove, slot, -1), s.last_slot),
        last_card=upd(torch.where(is_cardmove, card, -1), s.last_card),
        last_success=upd(success, s.last_success),
        last_added_info=upd(top_bonus, s.last_added_info),
        final_countdown=countdown,
    )
    all_complete = (fireworks >= R).all(1)
    over = (lives <= 0) | all_complete | (countdown <= 0)
    s3 = s3.replace(terminal=torch.where(do, over, s.terminal),
                    cur_player=upd((cur + 1) % P, s.cur_player))
    reward = (score(game, s3) - before).float() * do.float()
    return s3, reward


# ---------------------------------------------------------------------------
# canonical encoding (C++ State::Encode, section-ordered)
# ---------------------------------------------------------------------------

def _one_hot_or_zero(x: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] float32 one-hot of x, all zeros where x < 0."""
    oh = torch.nn.functional.one_hot(torch.clamp(x.long(), min=0), n).float()
    return oh * (x >= 0)[..., None].float()


def _thermometer(count: torch.Tensor, width: int) -> torch.Tensor:
    """[N, width] float32: bit j set where j < count [N]."""
    return (torch.arange(width, device=count.device)[None]
            < count[:, None]).float()


def _hand_one_hot(game: HanabiGame, s: HanabiState, q: torch.Tensor
                  ) -> torch.Tensor:
    """[N, H·C·R] one-hot of player q's cards (empty slots zero)."""
    H, CR = game.hand_size, game.colors * game.ranks
    cards = _row(s.hand_card, q).long()
    valid = (torch.arange(H, device=cards.device)[None]
             < _row(s.hand_n, q)[:, None]) & (cards >= 0)
    oh = torch.nn.functional.one_hot(torch.clamp(cards, 0, CR - 1), CR).float()
    return (oh * valid[..., None].float()).reshape(-1, H * CR)


def encode(game: HanabiGame, s: HanabiState, player: torch.Tensor
           ) -> torch.Tensor:
    """[N, obs_dim] float32 canonical observation of `player` [N]."""
    t = _tables(game, s.deck.device)
    C, R, P, H = game.colors, game.ranks, game.players, game.hand_size
    CR = C * R
    N, dev = s.deck.shape[0], s.deck.device
    player = player.long()
    parts = []

    # --- hands: the other players' visible cards, in relative order ---
    for off in range(1, P):
        parts.append(_hand_one_hot(game, s, (player + off) % P))
    parts.append(torch.stack([_row(s.hand_n, (player + off) % P) < H
                              for off in range(P)], 1).float())

    # --- board ---
    parts.append(_thermometer(game.deck_len - s.deck_ptr,
                              game.deck_len - P * H))
    parts.append((torch.arange(R, device=dev)[None, None]
                  == (s.fireworks[:, :, None] - 1)).float().reshape(N, CR))
    parts.append(_thermometer(s.info, game.max_info))
    parts.append(_thermometer(s.lives, game.max_life))

    # --- discards: per (color, rank) thermometer over the copy count ---
    parts.append((t["disc_j"][None]
                  < s.discards[:, t["disc_c"], t["disc_r"]]).float())

    # --- last action ---
    rel = lambda a: torch.where(a >= 0, (a.long() - player + P) % P, -1)
    parts.append(_one_hot_or_zero(rel(s.last_acting), P))
    lt = s.last_type.long()
    type_pos = torch.where((lt >= 0) & (lt <= 3),
                           t["type_order"][torch.clamp(lt, 0, 3)], -1)
    parts.append(_one_hot_or_zero(type_pos, 4))
    parts.append(_one_hot_or_zero(rel(s.last_target), P))
    parts.append(_one_hot_or_zero(s.last_color, C))
    parts.append(_one_hot_or_zero(s.last_rank, R))
    parts.append(((s.last_reveal[:, None] >> torch.arange(H, device=dev)[None])
                  & 1).float())
    parts.append(_one_hot_or_zero(s.last_slot, H))
    parts.append(_one_hot_or_zero(s.last_card, CR))
    parts.append(torch.stack([s.last_success, s.last_added_info], 1).float())

    # --- V0 belief of every player's slots, in relative order ---
    if not game.minimal:
        ranks = torch.arange(R, device=dev)
        count = (t["rank_counts"][None, None] - s.discards
                 - (s.fireworks[:, :, None] > ranks[None, None]).int())  # [N,C,R]
        qs = (player[:, None] + torch.arange(P, device=dev)[None]) % P  # [N,P]
        ar = torch.arange(N, device=dev)[:, None]
        kc, kr = s.know_color[ar, qs], s.know_rank[ar, qs]             # [N,P,H]
        hc, hr = s.hinted_color[ar, qs], s.hinted_rank[ar, qs]
        in_hand = torch.arange(H, device=dev)[None, None] \
            < s.hand_n[ar, qs][..., None]                               # [N,P,H]
        pc = (kc[..., None] >> torch.arange(C, device=dev)) & 1        # [..,C]
        pr = (kr[..., None] >> ranks) & 1                               # [..,R]
        plaus = pc[..., :, None] * pr[..., None, :]                     # [..,C,R]
        cnt = count[:, None, None]
        total = (plaus * cnt).sum((-1, -2), dtype=torch.int32)
        v0 = (plaus > 0) & (cnt > 0) & (cnt == total[..., None, None]) \
            & in_hand[..., None, None]
        hint = lambda h, n: _one_hot_or_zero(torch.where(in_hand, h, -1), n)
        belief = torch.cat([v0.float().reshape(N, P, H, CR), hint(hc, C),
                            hint(hr, R)], -1)
        parts.append(belief.reshape(N, P * H * (CR + C + R)))

    return torch.cat(parts, 1)


def encode_own_hand(game: HanabiGame, s: HanabiState, player: torch.Tensor
                    ) -> torch.Tensor:
    """[N, H·C·R] one-hot of `player`'s own cards (the critic's view)."""
    return _hand_one_hot(game, s, player.long())
