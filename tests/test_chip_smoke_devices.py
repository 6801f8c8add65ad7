"""chip_smoke.py's two-backend and multi-card phases on virtual CPU
devices: the stream-parity phase with two devices standing in for the
GPU and the CPU backend, all one-card phases at once, and the sharded
paths on three devices."""

import functools

import jax

import chip_smoke


def test_parity_phase_runs_on_two_cpu_devices():
    dev, ref = jax.devices("cpu")[:2]
    chip_smoke.phase_d(dev, ref, w=176, h=144, n_intra=1, n_ippp=4, gop=2)


def test_all_phases_run_at_once_at_qcif(capsys):
    dev, ref = jax.devices("cpu")[:2]
    p = functools.partial
    qcif = dict(w=176, h=144)
    chip_smoke.run_phases(dev, {
        "a": p(chip_smoke.phase_a, dev, n=2, **qcif),
        "b": p(chip_smoke.phase_b, dev, n=2, **qcif),
        "c": p(chip_smoke.phase_c, dev, n=5, gop=4, **qcif),
        "d": p(chip_smoke.phase_d, dev, ref, n_intra=1, n_ippp=4, gop=2,
               **qcif),
        "e": p(chip_smoke.phase_e, dev, ref, reps=1, **qcif),
    })
    out = capsys.readouterr().out
    assert all(f"[{k}] checks passed" in out for k in "abcde")
    assert "all phases passed" in out


def test_cards_phase_runs_on_virtual_cpu_devices():
    chip_smoke.phase_cards(jax.devices("cpu")[:3], w=176, h=144, gop=2)
