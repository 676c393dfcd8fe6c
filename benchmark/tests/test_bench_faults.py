"""A whole run of each cell, the look for a chip skipped, on the CPU's
plain path at a small size: sound, it is correct; with the timed path
broken underneath it is not; with a JAX module loaded it refuses."""

import sys
import types

import numpy as np
import pytest

import run

SMALL = {"vote.serve": {"rate": 3.0, "batch_max": 2, "check_requests": 3, "warm_s": 0.5},
         "mlp149.corpus": {"clips": 8, "check_clips": 4},
         "mlp149.train": {"epochs": 2}}
REGISTRY = {"vote.serve": run.BENCH / "candidates.json", "mlp149.corpus": None,
            "mlp149.train": run.BENCH / "candidates.json"}


def run_cell(cell: str, seconds: float = 1.5):
    ctx = run.Ctx(cell, 2**31 + 17, seconds, False, "cpu", overrides=SMALL[cell],
                  bench_file=REGISTRY[cell])
    return run.run(ctx, require_chip=False)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    code, res = run_cell(cell)
    assert code == 0 and res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s"}


def test_an_altered_answer_fails_the_vote(monkeypatch):
    from stutter_tpu_torch.infer import EnsemblePredictor

    orig = EnsemblePredictor.predict_batch

    def altered(self, clips, *a, **k):  # one member's answer moved where it is produced
        out = orig(self, clips, *a, **k)
        for r in out:
            m = r["members"]["transformer"]
            first = next(iter(m))
            m[first] = m[first] * (1 - 1e-3)
        return out

    monkeypatch.setattr(EnsemblePredictor, "predict_batch", altered)
    code, res = run_cell("vote.serve")
    assert code == 0 and not res["correct"]


@pytest.mark.parametrize("fault", ["feature_altered", "gate_skipped"])
def test_a_broken_corpus_pass_is_not_correct(monkeypatch, fault):
    import stutter_tpu_torch.denoise as dn
    import stutter_tpu_torch.ops.frontend as fe

    if fault == "feature_altered":
        orig = fe.extract_features_149_batch

        def broken(audio, lengths, *a, **k):
            out = orig(audio, lengths, *a, **k).clone()
            out[:, 125] *= 1 + 1e-3  # one chroma mean, altered where it is produced
            return out

        monkeypatch.setattr(fe, "extract_features_149_batch", broken)
    else:
        def broken(audio, lengths, *a, **k):  # the gate returns its input
            return audio / audio.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)

        monkeypatch.setattr(dn, "denoise_batch", broken)
    code, res = run_cell("mlp149.corpus")
    assert code == 0 and not res["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "loss_altered",
                                   "update_altered"])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    import stutter_tpu_torch.train.trainer as tr

    if fault == "state_unchanged":
        def still(self, x, y, w, keeps):  # the step returns its state as it found it
            self.steps_done += 1

        monkeypatch.setattr(tr.GridTrainer, "step", still)
    elif fault in ("half_batch", "loss_altered"):
        orig = tr.grid_losses

        def broken(weights, biases, x, y, w, keeps, cfg):
            if fault == "loss_altered":  # the loss altered where it is produced
                return orig(weights, biases, x, y, w, keeps, cfg) * (1 + 1e-3)
            h = x.shape[1] // 2  # half the batch left out, the mean over the rest
            return orig(weights, biases, x[:, :h], y[:, :h], w[:, :h],
                        None if keeps is None else [k[:, :h] for k in keeps], cfg)

        monkeypatch.setattr(tr, "grid_losses", broken)
    else:
        orig_lr = tr.learning_rate
        monkeypatch.setattr(tr, "learning_rate", lambda *a: orig_lr(*a) * (1 + 1e-2))
    code, res = run_cell("mlp149.train", 0.5)
    assert code == 0 and not res["correct"], res["checks"]


def test_a_loaded_jax_module_refuses_the_run(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, res = run_cell("mlp149.corpus", 0.5)
    assert code == 3 and res is None
    assert "jax" in capsys.readouterr().err


def test_no_result_without_a_chip(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = run.Ctx("mlp149.corpus", 1, 1.0, False, "cuda")
    assert run.run(ctx) == (2, None)


def test_control_reads_the_same_gaps_as_the_check():
    """On the CPU no lower precision exists, so the control reads 0; on the
    card (test_bench_control.py) it must fail a limit."""
    sys.path.insert(0, str(run.BENCH / "tools"))
    import control

    ctx = run.Ctx("mlp149.corpus", 3, 1.0, False, "cpu", overrides={"clips": 4})
    rows = control.control_rows(ctx, [3], 2)
    assert rows[0]["seed"] == 3 and np.isfinite(rows[0]["mfcc_gap"])
