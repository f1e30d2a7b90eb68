"""The repository's C++ Hanabi engine (`cpp/hanabi`, held bit for bit to
the reference's Hanabi Learning Environment by the repository's CPU
tests), built from its sources with g++ and driven through its
single-game C interface (`hanabi_state_*`), without the program's Python
package: the second engine that the Hanabi check replays every game
through, beside the plain tensor engine (`hanabi_engine`).

The library is built once per content of the sources, into
`.portbench_cache/hanabi/` inside the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCES = ROOT / "cpp" / "hanabi"
CACHE = ROOT / ".portbench_cache" / "hanabi"
_LIB = None


def load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    files = [SOURCES / n for n in ("hanabi.h", "hanabi.cc", "c_api.cc")]
    key = hashlib.sha256(b"".join(f.read_bytes() for f in files))
    so = CACHE / f"libhanabi_{key.hexdigest()[:16]}.so"
    if not so.exists():
        CACHE.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                        "-o", str(tmp), str(files[1]), str(files[2])],
                       check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i, i8p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int8)
    lib.hanabi_state_new.restype = vp
    lib.hanabi_state_new.argtypes = [i] * 7 + [i8p, i8p, i]
    lib.hanabi_state_free.argtypes = [vp]
    lib.hanabi_state_free.restype = None
    for name in ("hanabi_state_cur_player", "hanabi_state_terminal"):
        getattr(lib, name).argtypes = [vp]
        getattr(lib, name).restype = i
    lib.hanabi_state_legal.argtypes = [vp, i]
    lib.hanabi_state_legal.restype = i
    lib.hanabi_state_apply.argtypes = [vp, i]
    lib.hanabi_state_apply.restype = None
    for name in ("hanabi_state_encode", "hanabi_state_encode_ownhand",
                 "hanabi_state_legal_mask"):
        getattr(lib, name).argtypes = [vp, i, vp]
        getattr(lib, name).restype = None
    _LIB = lib
    return lib


def replay(game, decks: np.ndarray, seg: np.ndarray, seat: np.ndarray,
           uid: np.ndarray) -> dict:
    """Every act, in order, on one C++ game a segment: game `seg[a]`
    dealt from `decks[seg[a]]` (card ids in draw order), where seat
    `seat[a]` plays move `uid[a]` (applied where legal). -> the engine's
    view before each act: "cur" [A], "obs" [A, obs_dim], "own"
    [A, H·C·R], "legal" [A, moves]; and "terminal" [segments] after the
    segment's last act."""
    lib = load()
    C, R = game.colors, game.ranks
    A, S = len(seg), decks.shape[0]
    out = {"cur": np.full(A, -1, np.int32),
           "obs": np.zeros((A, game.obs_dim), np.float32),
           "own": np.zeros((A, game.ownhand_dim), np.float32),
           "legal": np.zeros((A, game.n_moves), np.float32),
           "terminal": np.zeros(S, bool)}
    colors = np.ascontiguousarray(decks // R, np.int8)
    ranks = np.ascontiguousarray(decks % R, np.int8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    ptr = lambda a, row: a.ctypes.data + row * a.strides[0]
    cur, enc, own = (lib.hanabi_state_cur_player, lib.hanabi_state_encode,
                     lib.hanabi_state_encode_ownhand)
    mask, legal, apply = (lib.hanabi_state_legal_mask, lib.hanabi_state_legal,
                          lib.hanabi_state_apply)
    bounds = np.flatnonzero(np.diff(seg)) + 1
    for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, A]):
        s = int(seg[lo])
        h = lib.hanabi_state_new(
            C, R, game.players, game.hand_size, game.max_info,
            game.max_life, int(game.minimal),
            ctypes.cast(ptr(colors, s), i8p), ctypes.cast(ptr(ranks, s), i8p),
            decks.shape[1])
        try:
            for a in range(lo, hi):
                p, u = int(seat[a]), int(uid[a])
                out["cur"][a] = cur(h)
                enc(h, p, ptr(out["obs"], a))
                own(h, p, ptr(out["own"], a))
                mask(h, p, ptr(out["legal"], a))
                if legal(h, u):
                    apply(h, u)
            out["terminal"][s] = bool(lib.hanabi_state_terminal(h))
        finally:
            lib.hanabi_state_free(h)
    return out
