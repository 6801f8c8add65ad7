"""chip_smoke.py: it refuses to report from the CPU backend, and its
one-device phases (normally 1080p on a GPU) run end to end at small
sizes on CPU devices."""

import jax
import pytest

import chip_smoke

QCIF = dict(w=176, h=144)


def test_main_refuses_cpu_backend(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("phase", ["a", "b", "c", "e"])
def test_phase_runs_at_qcif_on_cpu(phase):
    dev, ref = jax.devices("cpu")[:2]
    run = {
        "a": lambda: chip_smoke.phase_a(dev, n=2, **QCIF),
        "b": lambda: chip_smoke.phase_b(dev, n=2, **QCIF),
        "c": lambda: chip_smoke.phase_c(dev, n=5, gop=4, **QCIF),
        "e": lambda: chip_smoke.phase_e(dev, ref, reps=1, **QCIF),
    }
    warm = run[phase]()
    warm()


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/")
    return dev


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu_device):
    chip_smoke.run_phases(gpu_device, chip_smoke.one_card_phases(
        gpu_device, jax.devices("cpu")[0]))
