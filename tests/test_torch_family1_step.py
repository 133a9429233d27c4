"""The port's alternating step (``graphical_gan_tpu_torch/train/step.py``)
against the JAX ``make_train_step`` beyond cifar10 wali-gp: 3 iterations at
dim 8, B 4, f32, from the same parameters, batches and random draws (JAX's,
replayed from its registry stream), for mnist ``ali`` (k = 1, BN in D) and
mnist ``vegan-kl`` (k = 0: no D player, ``disc_opt == {}``, the
aggregated-posterior KL's Monte-Carlo draws passed in); and the CLI on the
CPU for mnist ``ali``, with resume. The tolerances are stated in
``tests/_torch_family1.py: check_states``.
"""

import os

import pytest

from _torch_family1 import check_states, run_steps


@pytest.mark.parametrize("mode", ["ali", "vegan-kl"])
def test_three_iterations_match_jax_step(mode):
    js, ts, costs = run_steps("mnist", mode)
    check_states(js, ts, costs, 1 if mode == "ali" else 0)


def test_cli_trains_mnist_on_cpu_and_resumes(tmp_path, capsys):
    from graphical_gan_tpu_torch.runs.gan_inference import main
    run_dir = str(tmp_path / "run")
    common = ["--dataset", "mnist", "--mode", "ali", "--dim", "8",
              "--batch-size", "4", "--device", "cpu", "--run-dir", run_dir,
              "--checkpoint-every", "2"]
    main(common + ["--iters", "3"])
    out = capsys.readouterr().out
    assert "iter 2\t" in out and "train disc cost" in out
    assert sorted(os.listdir(run_dir)) == sorted(
        ["config.json", "logfile.txt", "ckpt_1.npz", "ckpt_2.npz"])
    main(common + ["--iters", "5"])
    out = capsys.readouterr().out
    assert "iter 2\t" not in out and "iter 3\t" in out and "iter 4\t" in out
    assert "ckpt_4.npz" in os.listdir(run_dir)
