"""The operation and byte counts against counts done by hand: one U-Net
block's conv chain, a one-level U-Net step and a one-level PHiSeg step."""

from benchmark.harness import flops, timing
from benchmark.reference import phiseg, unet


def conv_flops(ci, co, k, pixels):
    return 2 * k * k * ci * co * pixels


def test_chain_cost_of_one_unet_block():
    # down1 of the registered U-Net at batch 12: 64x64, 32 -> 64 -> 64 -> 64 channels, float32
    stages = [(32, 64), (64, 64), (64, 64)]
    f, b = timing.chain_cost(12, 64, stages, itemsize=4)
    pixels = 12 * 64 * 64
    assert f == sum(2 * 9 * ci * co * pixels for ci, co in stages) == 2 * 9 * pixels * (32 * 64 + 2 * 64 * 64)
    assert b == 4 * (pixels * (32 + 64) + 9 * (32 * 64 + 64 * 64 + 64 * 64))
    ms, by = timing.bound(f, b, timing.PEAK_3XTF32_FLOPS)
    assert by == "operations" and abs(ms - f / (494.7e12 / 3) * 1e3) < 1e-12


def test_chain_least_time_sums_the_stages():
    m = unet.build({"filter_channels": [32, 64], "n_classes": 2, "image_size": [16, 16], "input_channels": 1})
    stages = flops.chain_stages(m, 2)
    assert stages == [(2, 16, 1, 32), (2, 16, 32, 32), (2, 16, 32, 32), (2, 8, 32, 64), (2, 8, 64, 64),
                      (2, 8, 64, 64), (2, 16, 96, 32), (2, 16, 32, 32), (2, 16, 32, 32)]
    want = sum(max(2 * 9 * ci * co * b * s * s / timing.PEAK_3XTF32_FLOPS,
                   4 * (b * s * s * (ci + co) + 9 * ci * co) / timing.PEAK_BYTES_S) for b, s, ci, co in stages)
    assert abs(flops.chain_least_s(m, 2) - want) < 1e-15


def test_one_level_unet_step():
    # three 3x3 convs and the 1x1 head at 8x8, batch 3; the backward takes each weight's gradient
    # (as many operations as its forward) and each input's but the image's
    m = unet.build({"filter_channels": [4], "n_classes": 2, "image_size": [8, 8], "input_channels": 1})
    px = 3 * 8 * 8
    fwd = [conv_flops(1, 4, 3, px), conv_flops(4, 4, 3, px), conv_flops(4, 4, 3, px), conv_flops(4, 2, 1, px)]
    assert flops.train_step(m, 3) == 2 * sum(fwd) + sum(fwd[1:])


def test_one_level_phiseg_step():
    # one resolution level and one latent level at 8x8, batch 2: each net's 3 trunk convs, 2 sample-z
    # convs and the 1x1 mu and sigma; the likelihood's 2 embed convs and its 1x1 head
    m = phiseg.build({"filter_channels": [4], "latent_levels": 1, "zdim": 2, "n_classes": 2,
                      "image_size": [8, 8], "input_channels": 1})
    px = 2 * 8 * 8

    def net(ci):
        return [conv_flops(ci, 4, 3, px), conv_flops(4, 4, 3, px), conv_flops(4, 4, 3, px),
                conv_flops(4, 4, 3, px), conv_flops(4, 4, 3, px), conv_flops(4, 2, 1, px), conv_flops(4, 2, 1, px)]

    posterior, prior = net(1 + 2), net(1)
    likelihood = [conv_flops(2, 4, 3, px), conv_flops(4, 4, 3, px), conv_flops(4, 2, 1, px)]
    fwd = posterior + prior + likelihood
    # no gradient of the inputs of the nets' first convs (the image, the mask)
    assert flops.train_step(m, 2) == 3 * sum(fwd) - posterior[0] - prior[0]
