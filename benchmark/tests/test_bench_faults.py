"""A whole run of the harness on the CPU at a small size, without the look
for a card: sound, it is correct; with the timed path broken underneath
in each way a frame cell can break, `correct` comes out false."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import SMALL


def stale_state(monkeypatch):
    """A frame that returns its state unchanged."""
    from nebulae_tpu_torch.engine.renderer import Renderer

    render = Renderer.render

    def stale(self, camera, sun=None):
        state = self.state
        out = render(self, camera, sun)
        self.state = state
        return out

    monkeypatch.setattr(Renderer, "render", stale)


def half_batch(monkeypatch):
    """Half of the pixels left out, the mean of the rest in their place."""
    import nebulae_tpu_torch.engine.renderer as r

    trace_samples = r.trace_samples

    def half(*args, **kw):
        rad, rng = trace_samples(*args, **kw)
        n = rad.shape[0] // 2
        return torch.cat([rad[:n], rad[:n].mean(0, keepdim=True).expand(rad.shape[0] - n, 3)]), rng

    monkeypatch.setattr(r, "trace_samples", half)


def altered_answer(monkeypatch):
    """The presented image altered where it is made: 2% darker."""
    import nebulae_tpu_torch.engine.renderer as r

    aces = r.aces_tonemap
    monkeypatch.setattr(r, "aces_tonemap", lambda hdr: aces(hdr) * 0.98)


def stale_step(monkeypatch):
    """A train step that returns its params and Adam's state unchanged."""
    import nebulae_tpu_torch.engine.train as t

    make = t.make_train_step

    def make_stale(*args, **kw):
        step, opt = make(*args, **kw)

        def stale(params, opt_state, cam, state, target):
            _p, _o, new_state, loss, img = step(params, opt_state, cam, state, target)
            return params, opt_state, new_state, loss, img

        return stale, opt

    monkeypatch.setattr(t, "make_train_step", make_stale)


def half_batch_loss(monkeypatch):
    """The loss over half of the image's rows, the mean taken over them."""
    import nebulae_tpu_torch.engine.train as t

    render_loss = t.render_loss

    def half(params, frozen, tables, cam, state, target, cfg, device=None, world=None):
        _loss, (new_state, img) = render_loss(params, frozen, tables, cam, state, target, cfg, device, world)
        n = img.shape[0] // 2
        return torch.mean((img[:n] - target[:n]) ** 2), (new_state, img)

    monkeypatch.setattr(t, "render_loss", half)


def altered_loss(monkeypatch):
    """The loss altered where it is made: 2% larger."""
    import nebulae_tpu_torch.engine.train as t

    render_loss = t.render_loss

    def scaled(*args, **kw):
        loss, aux = render_loss(*args, **kw)
        return loss * 1.02, aux

    monkeypatch.setattr(t, "render_loss", scaled)


FAULTS = {"frames": [stale_state, half_batch, altered_answer], "steps": [stale_step, half_batch_loss, altered_loss]}
KIND = {"pt4-still": "frames", "nrc8-orbit": "frames", "pt4-train": "steps"}


def run(bench, workload, seed):
    return harness.run_cell(bench, workload, seed, 0.5, False, "cpu", time.perf_counter(),
                            overrides=SMALL[workload], log=lambda line: None)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(bench, workload):
    out = run(bench, workload, 2**31 + 11)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] == 0


@pytest.mark.parametrize("workload,fault", [(w, i) for w in sorted(SMALL) for i in range(3)])
def test_fault_is_not_correct(bench, monkeypatch, workload, fault):
    FAULTS[KIND[workload]][fault](monkeypatch)
    out = run(bench, workload, 2**31 + 12)
    assert not out["result"]["correct"], out["checks"]
