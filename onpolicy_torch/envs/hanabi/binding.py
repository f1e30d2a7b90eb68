"""ctypes binding over the C++ Hanabi engine (`cpp/hanabi`).

The port's own copy of `onpolicy_tpu/envs/hanabi/binding.py` (the
reference's CFFI loader, `pyhanabi.py:42-115`), over the BATCHED C ABI:
one call steps or encodes the whole fleet. The shared library is built
from the sources in the checkout with g++ into `onpolicy_torch/_build/`,
again whenever a source is newer than it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[2]
CPP_DIR = _PKG.parent / "cpp" / "hanabi"
BUILD_DIR = _PKG / "_build"
SOURCES = ("hanabi.cc", "c_api.cc", "hanabi.h")
_LIB = None


def build() -> Path:
    """`_build/libhanabi.so`, compiled unless it is newer than every
    source. The compiler writes a temporary name that `os.replace` puts in
    place, so a process that loads the library never finds it half
    written while another builds it."""
    so = BUILD_DIR / "libhanabi.so"
    srcs = [CPP_DIR / s for s in SOURCES]
    if so.exists() and all(so.stat().st_mtime >= s.stat().st_mtime
                           for s in srcs):
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp),
         str(CPP_DIR / "hanabi.cc"), str(CPP_DIR / "c_api.cc")],
        check=True, cwd=CPP_DIR)
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.hanabi_batch_new.restype = ctypes.c_void_p
    lib.hanabi_batch_new.argtypes = [ctypes.c_int] * 8 + [ctypes.c_uint64]
    lib.hanabi_batch_free.argtypes = [ctypes.c_void_p]
    lib.hanabi_batch_free.restype = None
    for name in ("hanabi_max_moves", "hanabi_obs_dim", "hanabi_ownhand_dim"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.hanabi_batch_reset.argtypes = [ctypes.c_void_p, u8p]
    lib.hanabi_batch_reset.restype = None
    lib.hanabi_batch_step.argtypes = [ctypes.c_void_p, i32p, f32p]
    lib.hanabi_batch_step.restype = None
    lib.hanabi_batch_observe.argtypes = [ctypes.c_void_p] + [f32p] * 3 + \
        [i32p, u8p, i32p]
    lib.hanabi_batch_observe.restype = None
    lib.hanabi_batch_observe_player.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int, f32p]
    lib.hanabi_batch_observe_player.restype = None
    _LIB = lib
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class HanabiBatch:
    """N lockstep Hanabi games in native code."""

    def __init__(self, n_games: int, colors=5, ranks=5, players=2,
                 hand_size=-1, max_info=8, max_life=3, minimal=False,
                 seed=0):
        if hand_size <= 0:
            hand_size = 5 if players < 4 else 4
        self.lib = load_library()
        self.handle = ctypes.c_void_p(self.lib.hanabi_batch_new(
            n_games, colors, ranks, players, hand_size, max_info, max_life,
            int(minimal), seed))
        self.n_games = n_games
        self.players = players
        self.max_moves = self.lib.hanabi_max_moves(self.handle)
        self.obs_dim = self.lib.hanabi_obs_dim(self.handle)
        self.ownhand_dim = self.lib.hanabi_ownhand_dim(self.handle)
        N = n_games
        self._obs = np.zeros((N, self.obs_dim), np.float32)
        self._own = np.zeros((N, self.ownhand_dim), np.float32)
        self._avail = np.zeros((N, self.max_moves), np.float32)
        self._cur = np.zeros(N, np.int32)
        self._done = np.zeros(N, np.uint8)
        self._score = np.zeros(N, np.int32)
        self._rew = np.zeros(N, np.float32)

    def reset(self, mask=None):
        """Fresh games where `mask` [N] (all games if None)."""
        if mask is None:
            self.lib.hanabi_batch_reset(self.handle, None)
            return
        m = np.ascontiguousarray(np.asarray(mask, np.uint8))
        if m.shape != (self.n_games,):
            raise ValueError(f"reset mask of shape {m.shape}, want "
                             f"({self.n_games},)")
        self.lib.hanabi_batch_reset(self.handle, _ptr(m, ctypes.c_uint8))

    def step(self, actions) -> np.ndarray:
        """actions [N] int (-1 no-op) → rewards [N] (score deltas)."""
        a = np.ascontiguousarray(np.asarray(actions, np.int32))
        if a.shape != (self.n_games,):
            raise ValueError(f"actions of shape {a.shape}, want "
                             f"({self.n_games},)")
        self.lib.hanabi_batch_step(self.handle, _ptr(a, ctypes.c_int32),
                                   _ptr(self._rew, ctypes.c_float))
        return self._rew.copy()

    def observe_player(self, player: int) -> np.ndarray:
        """Canonical encodings of a FIXED seat's view, every game →
        [N, obs_dim]."""
        out = np.zeros((self.n_games, self.obs_dim), np.float32)
        self.lib.hanabi_batch_observe_player(self.handle, player,
                                             _ptr(out, ctypes.c_float))
        return out

    def observe(self):
        """→ (obs, ownhand, avail, cur_player, done, score) snapshots."""
        self.lib.hanabi_batch_observe(
            self.handle, _ptr(self._obs, ctypes.c_float),
            _ptr(self._own, ctypes.c_float),
            _ptr(self._avail, ctypes.c_float),
            _ptr(self._cur, ctypes.c_int32),
            _ptr(self._done, ctypes.c_uint8),
            _ptr(self._score, ctypes.c_int32))
        return (self._obs.copy(), self._own.copy(), self._avail.copy(),
                self._cur.copy(), self._done.astype(bool), self._score.copy())

    def close(self):
        if self.handle:
            self.lib.hanabi_batch_free(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
