"""RNG state tracker for hybrid parallelism (counterpart of the
reference's ``fleet/meta_parallel/parallel_layers/random.py``).

Each named state is an explicit ``torch.Generator`` a device. Inside
``rng_state(name)`` the device's default generator draws from the
named state (its state is swapped in, and back out on exit, as
Megatron's tracker does), so dropout inside the mp region can draw the
same masks on every mp rank or different ones, by the state it names.
``model_parallel_random_seed`` sets the two standard states: the global
seed, the same on every rank, and the tracked ``model_parallel_rng``
seeded per mp rank.
"""
from __future__ import annotations

import contextlib

import torch

from .....device import resolve_device

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _default_generator(device):
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index]
    return torch.default_generator


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed, device=None):
        """A new state ``name`` seeded with ``seed`` on ``device`` (the
        port's default device when None)."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.seeds_.add(seed)
        self.states_[name] = gen

    def get_states_tracker(self):
        return {n: g.get_state() for n, g in self.states_.items()}

    def set_states_tracker(self, states):
        for n, s in states.items():
            if n not in self.states_:
                raise ValueError(f"state {n} does not exist")
            self.states_[n].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        """The default generator of the state's device draws from the
        named state inside the block."""
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        tracked = self.states_[name]
        default = _default_generator(tracked.device)
        saved = default.get_state()
        default.set_state(tracked.get_state())
        try:
            yield
        finally:
            tracked.set_state(default.get_state())
            default.set_state(saved)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=100, device=None):
    """Seed the default generators with ``seed`` on every rank and track
    ``model_parallel_rng`` at ``seed + 1024 + mp rank`` (the reference's
    local seed ``seed + 1024``, made distinct per mp rank as upstream's
    is), on ``device`` (the port's default device when None)."""
    from ...base.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank,
                           device)
    torch.manual_seed(seed)
