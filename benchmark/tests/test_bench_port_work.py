"""The frozen work counts against hand counts, and the bound as the largest
of its three times."""
import pytest

from benchmark import work


def test_plane_work_matches_hand_count():
    # B = 2, M = 8, one head of k = 3, unlogged.
    w = work.plane_work(2, 8, [3], logged=False)
    assert w.products == 3 * 2 * 2 * 8 * 3          # raw, dq, dP
    assert w.elementwise == 2 * 8 * 3              # the BCE gradient
    assert w.bytes == 2 * 8 / 4 + 2 * 4 * 8 * 3 + 2 * 4 * 2 * 3
    logged = work.plane_work(2, 8, [3], logged=True)
    assert logged.elementwise == 3 * 2 * 8 * 3     # gradient + two logs
    assert logged.bytes == w.bytes + 4             # the loss value


def test_heads_add_their_widths():
    one = work.plane_work(4, 16, [9], logged=False)
    split = work.plane_work(4, 16, [2, 3, 4], logged=False)
    assert split.products == one.products
    assert split.elementwise == one.elementwise
    assert split.bytes == one.bytes


def test_projection_work_matches_hand_count():
    w = work.xv_work(3, 16, 2)
    assert w.products == 2 * 3 * 16 * 2
    assert w.bytes == 3 * 16 / 4 + 4 * 16 * 2 + 4 * 3 * 2
    assert work.dv_work(3, 16, 2) == w
    assert work.step_model_flops(3, 16, 2, [2, 3]) == \
        2 * 3 * 16 * (2 * 2 + 3 * 5)


@pytest.mark.parametrize("w, term", [
    (work.Work(products=495e12, elementwise=1.0, bytes=1.0), "products"),
    (work.Work(products=1.0, elementwise=67e12, bytes=1.0), "per-element"),
    (work.Work(products=1.0, elementwise=1.0, bytes=3.35e12), "bytes"),
])
def test_bound_is_the_largest_term_not_the_sum(w, term):
    seconds, which = work.bound(w)
    assert which == term
    assert seconds == pytest.approx(1.0)
    assert seconds < sum(w.times().values())


def test_full_width_bounds():
    M = 1_000_000
    t, term = work.bound(work.plane_work(800, M, range(2, 11), False))
    assert term == "per-element" and t == pytest.approx(800 * M * 54 / 67e12)
    t, term = work.bound(work.xv_work(4096, M, 8))
    assert term == "bytes"


def test_period_bound_sums_each_steps_bound():
    steps = [(800, False), (800, True), (96, True)]
    total = work.period_bound(steps, 1000, 8, [4], "plane")
    assert total == pytest.approx(sum(
        work.bound(work.plane_work(b, 1000, [4], lg))[0] for b, lg in steps))
    with pytest.raises(ValueError):
        work.period_bound(steps, 1000, 8, [4], "encoder")
