"""The plain reference against the port's CPU path at a tiny size: one
step's loss and gradients, three Adam steps, and the Q pass. (The test
imports both; the reference imports nothing of the port.)"""
import numpy as np
import torch

from benchmark import plans, reference, sim

from ._tiny import tiny_cell


def _setup(seed=11):
    cell = tiny_cell()
    packed, P = sim.simulate_panel(cell.traffic, seed, torch.device("cpu"))
    params = sim.init_params(cell.config, P, sim.padded_snps(cell.traffic),
                             seed, torch.device("cpu"))
    return cell, packed, params


def _port_model(params, ks):
    from neural_admixture_tpu_torch.models import qp
    return qp.params_from_numpy(params, ks, "cpu")


def test_one_step_matches_the_port():
    from neural_admixture_tpu_torch.ops.fused_step import fused_training_loss
    cell, packed, params = _setup()
    M, ks = cell.traffic["snps"], cell.config["ks"]
    batch = torch.from_numpy(packed[:64])
    loss, grads = reference.loss_and_grads(reference.to_device(params, "cpu"),
                                           batch, M, 1024)
    model = _port_model(params, ks)
    m_pad = packed.shape[1] * 4
    col_mask = (torch.arange(m_pad) < M).float()
    port_loss, _ = fused_training_loss(model, batch, col_mask,
                                       torch.ones(64), True, False, True)
    port_loss.backward()
    assert abs(float(port_loss.detach()) - loss) <= 1e-5 * abs(loss)
    assert torch.allclose(model.V.grad, grads["V"], rtol=1e-4, atol=1e-3)
    assert torch.allclose(model.decoders["k3"].grad, grads["decoders/k3"],
                          rtol=1e-4, atol=1e-3)
    assert torch.allclose(model.common_encoder[0].weight.grad,
                          grads["common/kernel"].T, rtol=1e-4, atol=1e-3)


def test_three_adam_steps_match_the_ports_trainer():
    from neural_admixture_tpu_torch.train.engine import (
        NeuralAdmixtureTrainer, TrainConfig)
    cell, packed, params = _setup(12)
    c, t = cell.config, cell.traffic
    N, M = t["samples"], t["snps"]
    seed = 2**31 + 77
    ps = plans.epoch_plans(N, c["batch_size"], 16, 1, seed)
    order = plans.pre_shuffle(N, seed)
    batches = [torch.from_numpy(packed[order[plans.batch_rows(
        ps[0][0][i], 16)]]) for i in range(3)]
    ref = reference.train_steps(params, batches, M, c["learning_rate"],
                                tuple(c["betas"]), c["adam_eps"], 1024)
    # the port's trainer over that epoch, its first three steps read as
    # the harness reads them
    cfg = TrainConfig(epochs=1, batch_size=c["batch_size"],
                      learning_rate=c["learning_rate"], seed=seed,
                      hidden_size=c["hidden_size"],
                      n_components=c["n_components"], ks=c["ks"],
                      progress=False, sample_block=16, device="cpu",
                      stream=False)
    from benchmark import harness
    p0 = reference.to_device(params, "cpu")
    watch = harness.Steps(3, c["betas"][0], p0)
    trainer = harness.observed_trainer(watch)(cfg)
    trainer.launch_training(None, packed, None, M, N, init_params=params,
                            plans=lambda e: ps[e])
    prog = watch.numbers()
    np.testing.assert_allclose(prog["loss"], ref["loss"], rtol=1e-6)
    for k, v in ref["grad"].items():
        assert abs(prog["grad"][k] - v) <= 1e-5 * max(v, 1e-3), k
    for k, v in ref["change"].items():
        assert abs(prog["change"][k] - v) <= 1e-4 * max(v, 1e-6), k


def test_q_pass_matches_the_port():
    cell, packed, params = _setup(13)
    model = _port_model(params, cell.config["ks"])
    with torch.no_grad():
        port = model(torch.from_numpy(packed))
    ref = reference.q_pass(params, packed, "cpu", 1024, block_rows=128)
    for hk, q in port.items():
        np.testing.assert_allclose(q.numpy(), ref[hk], atol=2e-6)


def test_a_replayed_step_matches_the_ports_trainer_mid_run():
    """Adam's step from the program's state deep in a run (moments and
    step count in play, the masked remainder batch among them): the
    reference's gradient and change against the port's, as the harness
    reads them."""
    from neural_admixture_tpu_torch.train.engine import TrainConfig
    from benchmark import harness
    cell, packed, params = _setup(14)
    c, t = cell.config, cell.traffic
    N, M = t["samples"], t["snps"]
    seed = 2**31 + 78
    ps = plans.epoch_plans(N, c["batch_size"], 16, 6, seed)
    _, nb, _, _ = plans.geometry(N, c["batch_size"], 16)
    order = plans.pre_shuffle(N, seed)
    targets = harness.window_steps(nb, 6)
    cfg = TrainConfig(epochs=6, batch_size=c["batch_size"],
                      learning_rate=c["learning_rate"], seed=seed,
                      hidden_size=c["hidden_size"],
                      n_components=c["n_components"], ks=c["ks"],
                      progress=False, sample_block=16, device="cpu",
                      stream=False)
    watch = harness.Steps(3, c["betas"][0], reference.to_device(params, "cpu"),
                          [i for i, _, _ in targets])
    trainer = harness.observed_trainer(watch)(cfg)
    _, _, out = trainer.launch_training(None, packed, None, M, N,
                                        init_params=params,
                                        plans=lambda e: ps[e])
    assert harness.params_differ(out, watch.final) == 0
    for i, e, j in targets:
        state, step = watch.window_state(i)
        assert step == i
        ids = ps[e][0][j] if j < nb - 1 else ps[e][1]
        rows = plans.batch_rows(ids, 16)
        batch = torch.from_numpy(packed[order[rows[rows < N]]])
        ref = reference.replay_step(state, step + 1, batch, M,
                                    c["learning_rate"], tuple(c["betas"]),
                                    c["adam_eps"], 1024)
        prog = watch.window_numbers(i)
        if e % c["log_every"] == 0:
            np.testing.assert_allclose(prog["loss"], ref["loss"], rtol=1e-6)
        else:
            assert prog["loss"] == []
        for k, v in ref["grad"].items():
            assert abs(prog["grad"][k] - v) <= 1e-4 * max(v, 1e-3), (i, k)
        for k, v in ref["change"].items():
            assert abs(prog["change"][k] - v) <= 1e-4 * max(v, 1e-6), (i, k)
