"""The port's training CLI, ``python -m repro_torch.launch.train``, beside
the JAX package's: ``--smoke`` prints the same ``done: step N loss X
rollbacks R`` line (the losses differ: the synthetic batches come from
different generators), ``--distributed`` is refused with exit 2 and names
its ROADMAP item, and without CUDA and without ``--device cpu`` the CLI
raises instead of falling back to the CPU."""

import re

import pytest
import torch

import repro.launch.train as jax_cli
import repro_torch.launch.train as port_cli

DONE = re.compile(r"^done: step (\d+) loss (\d+\.\d{4}) rollbacks (\d+)$")


@pytest.mark.parametrize("arch", ["qwen2-1.5b"])
def test_smoke_prints_the_reference_line(arch, tmp_path, capsys):
    assert jax_cli.main(["--arch", arch, "--smoke", "--ckpt-dir",
                         str(tmp_path / "jax")]) == 0
    want = DONE.match(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path / "port")]) == 0
    got = DONE.match(capsys.readouterr().out.strip().splitlines()[-1])
    assert want and got
    assert got.group(1) == want.group(1) == "10"
    assert got.group(3) == want.group(3) == "0"
    assert 0.0 < float(got.group(2)) < 10.0


def test_distributed_is_refused(capsys, tmp_path):
    """``--distributed`` is no longer refused: with one device (here the
    CPU) it trains single-device, as the JAX package's CLI does with one
    device, and says so first."""
    assert port_cli.main(["--arch", "qwen2-1.5b", "--distributed",
                          "--device", "cpu", "--smoke", "--ckpt-dir",
                          str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == ("--distributed with one visible device: training "
                      "single-device on cpu")
    assert out[-1].startswith("done: step 10 loss ")


def test_without_cuda_the_cli_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--arch", "qwen2-1.5b", "--smoke", "--ckpt-dir",
                       str(tmp_path)])
