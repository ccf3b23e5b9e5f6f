"""K3's launch plan (kernels/group_cd.plan_launch) on the CPU: how the
group-lasso kernel spreads each alpha over a thread-block cluster. The
card's occupancy is stood in for by a function of the cluster size, as
cudaOccupancyMaxActiveClusters reports it for one block of 1024 threads an
SM on an H100 whose SMs sit in GPCs of unequal size."""
import pytest

from channel_pruning_tpu_torch.kernels import group_cd

GPCS = (18, 18, 16, 16, 16, 16, 16, 16)     # 132 SMs
UNEVEN = (18, 18, 18, 18, 16, 16, 14, 14)   # 132 SMs, two small GPCs


def h100_like(variant, k, nbytes, gpcs=GPCS):
    """Clusters of k blocks resident at once: k SMs of one GPC each."""
    assert variant in ("smem", "global")
    assert nbytes + group_cd.STATIC_SMEM <= group_cd.SMEM_LIMIT
    return sum(g // k for g in gpcs)


SHAPES = [(c, n, a) for c in (1, 2, 3, 7, 37, 256, 512, 2048, 4096)
          for n in (1, 5, 31, 256, 1100, 2048, group_cd.MAX_N)
          for a in (1, 3, 16, 64)]


@pytest.mark.parametrize("c,n,a", SHAPES)
def test_every_row_owned_once_and_bytes_within_the_limit(c, n, a):
    plan = group_cd.plan_launch(c, n, a, h100_like)
    owned = sorted(i for r in range(plan.k)
                   for i in group_cd.block_rows(c, plan.k, r))
    assert owned == list(range(c))            # once each
    counts = [len(group_cd.block_rows(c, plan.k, r)) for r in range(plan.k)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    assert plan.rows == max(counts)
    assert plan.smem_bytes == group_cd.smem_bytes(plan.variant, c, n,
                                                  plan.rows)
    if plan.variant == "global":      # Q's rows fill the spare bytes
        q_rows = plan.smem_bytes // (4 * n) - 3
        assert 0 <= q_rows <= plan.rows
        assert q_rows == plan.rows or (plan.smem_bytes + 4 * n
                                       + group_cd.STATIC_SMEM
                                       > group_cd.SMEM_LIMIT)
    assert plan.smem_bytes + group_cd.STATIC_SMEM <= group_cd.SMEM_LIMIT
    assert 2 <= plan.k <= (16 if a == 1 else 8) or c == plan.k == 1
    assert plan.active_clusters == h100_like(plan.variant, plan.k,
                                             plan.smem_bytes)


def test_smem_bytes_count_the_slices():
    # two delta slots and the solved row; the smem variant adds G's columns
    # (c x rows) and C and B (rows x n each): 3 slices of 32 KB at
    # (256, 256) with K = 8, Q's 32 rows in registers (8 a thread)
    assert group_cd.smem_bytes("global", 256, 256, 32) == 4 * 768 + 4 * 32 * 256
    # the res5 shape: 341 rows of 512, 110 of them in shared memory
    assert group_cd.smem_bytes("global", 2048, 512, 341) == 4 * 512 * (3 + 110)
    assert group_cd.smem_bytes("smem", 256, 256, 32) == \
        4 * 768 + 3 * 4 * 32 * 256
    assert group_cd.registers_hold(256, 32)
    assert group_cd.registers_hold(600, 12) and not group_cd.registers_hold(600, 13)
    assert not group_cd.registers_hold(1025, 1)


@pytest.mark.parametrize("c,n,a,variant,k", [
    (256, 256, 16, "smem", 8),       # 4 slices of 32 KB
    (2048, 512, 16, "global", 8),    # Q 4 MB an alpha: no cluster holds it
    (512, 2048, 16, "global", 8),
    (64, 1500, 16, "global", 8),     # n > 1024: no register variant
    (96, 600, 16, "smem", 8),        # 12 rows a thread: the registers' limit
    (104, 600, 16, "global", 8),     # 13 rows a thread
    (300, 1100, 16, "global", 8),
    (256, 256, 1, "smem", 16),       # one alpha: the non-portable 16
    (37, 64, 16, "smem", 8),
    (3, 5, 16, "smem", 3),           # at most one block a row
    (1, 8, 4, "smem", 1),
])
def test_variant_and_cluster_size_per_shape(c, n, a, variant, k):
    plan = group_cd.plan_launch(c, n, a, h100_like)
    assert (plan.variant, plan.k, plan.waves) == (variant, k, 1)


def test_smem_variant_only_where_the_slices_fit():
    for c, n in ((256, 256), (512, 512), (128, 2048), (1024, 64), (300, 40)):
        plan = group_cd.plan_launch(c, n, 16, h100_like)
        rows = plan.rows
        fits = (group_cd.smem_bytes("smem", c, n, rows) + group_cd.STATIC_SMEM
                <= group_cd.SMEM_LIMIT and group_cd.registers_hold(n, rows))
        assert plan.variant == ("smem" if fits else "global")


@pytest.mark.parametrize("gpcs", [GPCS, UNEVEN])
@pytest.mark.parametrize("a", [1, 2, 8, 14, 16, 22, 33, 44, 66])
def test_the_alphas_clusters_fit_in_one_wave(a, gpcs):
    """The largest K whose A clusters are all resident at once: where two
    GPCs hold 14 SMs, only 14 clusters of 8 fit, so 16 alphas take 7
    blocks each (16 clusters of 7 fit); 66 alphas take 2 blocks each."""
    def card(variant, k, nbytes):
        return h100_like(variant, k, nbytes, gpcs)

    plan = group_cd.plan_launch(2048, 512, a, card)
    assert plan.waves == 1 and plan.active_clusters >= a
    bigger = [k for k in range(plan.k + 1, 9 if a > 1 else 17)
              if card("global", k, 0) >= a]
    assert not bigger
    if a == 16:
        assert plan.k == (8 if gpcs == GPCS else 7)


def test_more_alphas_than_one_wave_holds():
    """67 alphas outgrow one wave at every K: the plan takes the fewest
    waves per block (K = 5: 3 waves of 24 clusters, 0.6 a block)."""
    plan = group_cd.plan_launch(2048, 512, 67, h100_like)
    assert plan.waves > 1
    best = min(-(-67 // h100_like("global", k, 0)) / k for k in range(2, 9))
    assert plan.waves / plan.k == best and plan.k == 5


def test_a_cluster_size_the_card_refuses_is_skipped():
    def no_eight(variant, k, nbytes):
        return 0 if k == 8 else h100_like(variant, k, nbytes)

    plan = group_cd.plan_launch(256, 256, 4, no_eight)
    assert plan.k == 7


@pytest.mark.parametrize("c,n,a", [(0, 4, 16), (4, 0, 16), (4, 4, 0),
                                   (4, group_cd.MAX_N + 1, 16)])
def test_plan_refuses_what_the_kernel_cannot_take(c, n, a):
    with pytest.raises(ValueError, match="K3 takes"):
        group_cd.plan_launch(c, n, a, h100_like)


def test_plan_refuses_when_no_cluster_fits():
    with pytest.raises(ValueError, match="no cluster"):
        group_cd.plan_launch(256, 256, 16, lambda v, k, b: 0)
    # a card with less shared memory: the smem variant gives way to global
    plan = group_cd.plan_launch(256, 256, 16, lambda v, k, b: 16,
                                smem_limit=48 * 1024)
    assert plan.variant == "global"


def test_consecutive_rows_have_different_owners():
    """The owner of row j solves it while the others update their rows
    with delta_{j-1}: no block owns two consecutive rows (k >= 2)."""
    for c, k in ((37, 8), (2048, 6), (3, 3), (256, 16)):
        owner = {i: r for r in range(k) for i in group_cd.block_rows(c, k, r)}
        assert all(owner[j] != owner[j + 1] for j in range(c - 1))
    assert list(group_cd.block_rows(37, 8, 5)) == [5, 13, 21, 29]


def six_wide(variant, k, nbytes):
    """The H100 that ran ResNet-50 2x: 17 clusters of 6 resident at once,
    fewer than 16 of 7 or of 8, so 16 alphas take K = 6."""
    return {6: 17, 7: 15, 8: 14}.get(k) or h100_like(variant, k, nbytes)


# ResNet-50 2x's 1x1 consumers under dic.grplasso, (c, n): the variant on a
# card that fits 16 clusters of 8 and on one that fits 16 of 6, and at K = 6
# the rows a block owns and how many of its rows of Q the global variant
# keeps in shared memory
@pytest.mark.parametrize("c,n,variant8,variant6,rows6,q_rows6", [
    (64, 64, "smem", "smem", 11, 11),
    (256, 64, "smem", "smem", 43, 43),
    (64, 256, "smem", "smem", 11, 11),
    (256, 128, "smem", "smem", 43, 43),
    (512, 128, "smem", "global", 86, 86),     # 86 rows of G: 264 KB at K = 6
    (128, 512, "smem", "smem", 22, 22),       # 11 rows of Q a thread
    (512, 256, "global", "global", 86, 86),   # 22 rows a thread: no registers
    (256, 1024, "global", "global", 43, 43),
    (1024, 256, "global", "global", 171, 171),
    (1024, 512, "global", "global", 171, 110),
    (2048, 512, "global", "global", 342, 110),
    (512, 2048, "global", "global", 86, 25),
])
def test_plan_of_each_resnet50_grplasso_class(c, n, variant8, variant6, rows6,
                                              q_rows6):
    wide = group_cd.plan_launch(c, n, 16, h100_like)
    assert (wide.variant, wide.k, wide.waves) == (variant8, 8, 1)
    plan = group_cd.plan_launch(c, n, 16, six_wide)
    assert (plan.variant, plan.k, plan.waves, plan.rows) == (variant6, 6, 1, rows6)
    assert plan.smem_bytes + group_cd.STATIC_SMEM <= group_cd.SMEM_LIMIT
    if plan.variant == "global":
        assert plan.smem_bytes == 4 * n * (3 + q_rows6)
    else:
        assert group_cd.registers_hold(n, rows6)
        assert plan.smem_bytes == 4 * (3 * n + rows6 * (c + 2 * n))
    owned = sorted(i for r in range(plan.k)
                   for i in group_cd.block_rows(c, plan.k, r))
    assert owned == list(range(c))
