"""The simulated panel against a plain unpack, its model's frequencies,
the weights' layout, and the plans."""
import numpy as np
import torch

from benchmark import plans, sim

from ._tiny import tiny_cell


def plain_unpack(packed, M):
    out = np.zeros((packed.shape[0], packed.shape[1] * 4), np.uint8)
    for j in range(packed.shape[1] * 4):
        out[:, j] = (packed[:, j // 4] >> (2 * (j % 4))) & 3
    return out[:, :M], out[:, M:]


def test_packed_codes_are_the_model_genotypes():
    cell = tiny_cell(samples=400, snps=1000)
    t = cell.traffic
    packed, P = sim.simulate_panel(t, 7, torch.device("cpu"),
                                   block_rows=128)
    assert packed.shape == (400, 2048 // 4) and packed.dtype == np.uint8
    codes, pad = plain_unpack(packed, 1000)
    assert not pad.any()
    missing = codes == 3
    assert abs(missing.mean() - t["missing_rate"]) < 0.004
    # the dosage's mean per SNP follows the population-average frequency
    Pt, Qt = sim.truth(t, 7, torch.device("cpu"))
    assert torch.equal(Pt, P)
    f = (Qt @ Pt.T).numpy()
    g = np.where(missing, np.nan, codes.astype(float))
    assert abs(np.nanmean(g) - 2 * f.mean()) < 0.02
    assert np.corrcoef(np.nanmean(g, 0), 2 * f.mean(0))[0, 1] > 0.9
    again, _ = sim.simulate_panel(t, 7, torch.device("cpu"), block_rows=128)
    assert np.array_equal(packed, again)
    other, _ = sim.simulate_panel(t, 8, torch.device("cpu"), block_rows=128)
    assert not np.array_equal(packed, other)


def test_packing_matches_a_plain_unpack():
    codes = torch.randint(0, 4, (5, 37), dtype=torch.uint8)
    packed = sim.pack_codes(codes, 40)
    assert packed.shape == (5, 10)
    got, pad = plain_unpack(packed.numpy(), 37)
    assert np.array_equal(got, codes.numpy()) and not pad.any()


def test_weights_have_the_layout_launch_training_takes():
    cell = tiny_cell()
    P, _ = sim.truth(cell.traffic, 3, torch.device("cpu"))
    p = sim.init_params(cell.config, P, 4096, 3, torch.device("cpu"))
    V = p["V"]
    assert V.shape == (4096, 4) and not V[3000:].any()
    assert np.allclose(V.T @ V, np.eye(4), atol=1e-5)
    assert p["common"]["kernel"].shape == (4, 16)
    for k in (2, 3):
        assert p["heads"][f"k{k}"]["kernel"].shape == (16, k)
        dec = p["decoders"][f"k{k}"]
        assert dec.shape == (k, 4096) and not dec[:, 3000:].any()
        assert dec[:, :3000].min() >= sim.P_CLIP
        assert dec[:, :3000].max() <= 1 - sim.P_CLIP


def test_plans_cover_every_row_once_and_match_the_ports_geometry():
    from neural_admixture_tpu_torch.train import engine
    for N, B in ((300, 64), (100_000, 4096), (100_000, 800), (1000, 800)):
        assert plans.geometry(N, B, 16) == engine.block_geometry(N, B, 16)
        ps = plans.epoch_plans(N, B, 16, 3, 2**31 + 5)
        b_round, nb, b_rem, n_rows = plans.geometry(N, B, 16)
        for full, rem in ps:
            assert full.shape == (nb - 1, b_round // 16)
            assert rem.size * 16 == b_rem
            rows = np.concatenate([plans.batch_rows(i, 16)
                                   for i in list(full) + [rem]])
            assert np.array_equal(np.sort(rows), np.arange(n_rows))
        assert not np.array_equal(ps[0][0], ps[1][0])
    assert np.array_equal(plans.pre_shuffle(1000, 2**31 + 9),
                          np.random.default_rng(2**31 + 9).permutation(1000))
