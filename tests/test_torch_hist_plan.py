"""The layout of the cluster histogram kernels (``ops/image.hist256_plan``),
checked on the CPU from the shapes alone: the clusters' slices cover every
byte of an image exactly once, in 16-byte multiples; the cluster size is a
power of two in [2, 16] ([2, 8] for the equalize) and divides the grid;
the shared memory fits the H100's 227 KB and agrees with the layout of
``hist256_cluster.cuh``; the grid has no 65,535-image limit."""
import pytest

from semantic_segmentation_torch.ops.image import (MAX_CLUSTER,
                                                   MAX_CLUSTER_EQUALIZE,
                                                   SMEM_MAX, SMS,
                                                   hist256_plan,
                                                   hist256_slices)

# (images, hw, c): the trainer's equalize, the benchmark's histogram, the
# cold benchmark shape, a 7 x 9 image, an RGB batch, hw off multiples of 16
# (250^2), and 70,000 tiny images
SHAPES = [(2, 256 * 256, 1), (4, 256 * 256, 1), (64, 512 * 512, 1),
          (1, 7 * 9, 1), (3, 64 * 48, 3), (2, 250 * 250, 1),
          (70000, 8 * 8, 1)]


def _smem(plan, c, equalize):
    """The dynamic shared bytes of hist256_cluster.cuh's layout: the CTA's
    counts, its slots (a row per CTA of the cluster: all c x 256 bins for
    the equalize, the CTA's own 256 / cluster for the histogram) and the
    kept slice."""
    slots = plan.cluster * c * 256 if equalize else 256
    counts = 4 * (c * 256 + slots)
    return counts + (plan.slice_bytes + 16 if plan.keep else 0)


@pytest.mark.parametrize("equalize", [False, True], ids=["hist", "equalize"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_byte_once_and_fits(shape, equalize):
    n, hw, c = shape
    plan = hist256_plan(n, hw, c, equalize)
    nbytes = hw * c
    assert 2 <= plan.cluster <= (MAX_CLUSTER_EQUALIZE if equalize else
                                 MAX_CLUSTER)
    assert MAX_CLUSTER == 16 and MAX_CLUSTER_EQUALIZE == 8
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.ctas == plan.cluster * n and plan.ctas % plan.cluster == 0
    assert plan.slice_bytes % 16 == 0 and plan.slice_bytes >= 16
    slices = hist256_slices(plan, nbytes)
    covered = [0] * nbytes
    for start, stop in slices:
        assert start % 16 == 0 and stop - start <= plan.slice_bytes
        for i in range(start, stop):
            covered[i] += 1
    assert covered == [1] * nbytes
    assert plan.smem_bytes == _smem(plan, c, equalize)
    assert plan.smem_bytes <= SMEM_MAX <= 227 * 1024
    if not equalize:
        assert not plan.keep


def test_plan_fills_the_card_when_the_batch_is_small():
    # the trainer's two 256^2 images: 8-CTA clusters, 8 KB slices, 16 SMs
    # for the equalize; 16-CTA clusters and 4 KB slices for the histogram
    plan = hist256_plan(2, 256 * 256, 1, True)
    assert (plan.cluster, plan.ctas, plan.slice_bytes) == (8, 16, 8192)
    assert plan.keep
    plan = hist256_plan(2, 256 * 256)
    assert (plan.cluster, plan.ctas, plan.slice_bytes) == (16, 32, 4096)
    # the cold benchmark shape: 8-CTA clusters put 512 CTAs on 132 SMs
    plan = hist256_plan(64, 512 * 512, 1, True)
    assert plan.cluster == 8 and plan.ctas >= 2 * SMS and plan.keep
    assert plan.slice_bytes == 32768


def test_plan_has_no_image_limit():
    plan = hist256_plan(70000, 64)
    assert plan.cluster == 2 and plan.ctas == 140000 > 65535


def test_plan_streams_slices_too_large_for_shared_memory():
    plan = hist256_plan(1, 4096 * 4096, 1, True)
    assert plan.cluster == 8 and not plan.keep
    assert plan.smem_bytes == _smem(plan, 1, True) <= SMEM_MAX


@pytest.mark.parametrize("equalize", [False, True], ids=["hist", "equalize"])
def test_plan_halves_the_cluster_for_small_images(equalize):
    # a CTA gets at least one 16-byte load a thread (4 KB) while the
    # cluster is above 2: 16 KB images take clusters of 4, 7 x 9 of 2
    plan = hist256_plan(1, 16 * 1024, 1, equalize)
    assert (plan.cluster, plan.slice_bytes) == (4, 4096)
    plan = hist256_plan(1, 7 * 9, 1, equalize)
    assert (plan.cluster, plan.slice_bytes) == (2, 32)


def test_plan_refuses_counts_past_shared_memory():
    # 240 channels of slots need more than 227 KB even in clusters of 2
    with pytest.raises(ValueError):
        hist256_plan(1, 64, 240, True)
