"""Hold the kernels whose bits must not move against another tree's.

Saves, from seeded operands, the outputs of the dense kernels on the layers
a change must leave alone: the forward, dgrad and wgrad, f32 and bf16,
window and streamed, at VGG-16's layers past conv1_2 (batch 2, a 56x56
entry) and AlexNet's two-tower layers (batch 2, 227x227; conv1 in f32
alone, where the bf16 build takes the narrow rows).  Run it with each
tree's ``src`` first on ``PYTHONPATH`` (``--save``), then ``--compare`` the
two files: it prints how many outputs are bit for bit the same and names
the others.  Needs an H100 and nvcc::

    PYTHONPATH=parent/src python -m repro_torch.launch.bits_ab \\
        --save bits_parent.pt
    PYTHONPATH=src python -m repro_torch.launch.bits_ab --save bits_this.pt
    python -m repro_torch.launch.bits_ab --compare bits_parent.pt \\
        bits_this.pt
"""
from __future__ import annotations

import argparse

import torch


def outputs(dev) -> dict:
    """The outputs, by name, on the CPU."""
    from repro_torch.configs.cnn import alexnet_blocked, vgg16_layers
    from repro_torch.kernels import direct_conv2d as dck
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    res = {}

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=gen)
    h, layers = 56, []
    for ci, co, s in vgg16_layers()[2:]:
        layers.append((ci, co, s, h))
        h = -(-h // s)
    with torch.no_grad():
        for ci, co, s, hh in layers:
            cib, cob, n = min(ci, 128), min(co, 128), 2
            x = rnd(n, ci // cib, hh, hh, cib)
            w = rnd(co // cob, ci // cib, 3, 3, cib, cob) / (9 * ci) ** 0.5
            b = rnd(co // cob, cob)
            ho = -(-hh // s)
            z, g = rnd(n, co // cob, ho, ho, cob), rnd(n, co // cob, ho, ho,
                                                       cob)
            key = f"{ci}-{co}-{s}-{hh}"
            for prec in ("f32", "bf16"):
                xx = x.to(bf) if prec == "bf16" else x
                for stream in (False, True):
                    tag = f"{prec} {'stream' if stream else 'window'} {key}"
                    res[f"fwd {tag}"] = dck.direct_conv2d_blocked(
                        xx, w, b, s, "SAME", "relu", precision=prec,
                        stream=stream).float().cpu()
                    res[f"wgrad {tag}"] = dck.direct_conv2d_wgrad(
                        xx, g, 3, 3, s, "SAME", z, "relu", True,
                        stream=stream, precision=prec)[0].cpu()
                    res[f"dgrad {tag}"] = dck.direct_conv2d_dgrad(
                        g, w, (hh, hh), s, "SAME", z, "relu", stream=stream,
                        precision=prec).float().cpu()
        model = alexnet_blocked(device=dev,
                                generator=torch.Generator().manual_seed(3))
        hh = 227
        for i, conv in enumerate(model.convs):
            spec = conv.spec(2, hh, hh)
            cib, cob = conv.in_pencil, conv.w.shape[5]
            x = rnd(2, spec.ci // cib, hh, hh, cib)
            z = rnd(2, spec.co // cob, spec.ho, spec.wo, cob)
            g = rnd(2, spec.co // cob, spec.ho, spec.wo, cob)
            for prec in ("f32", "bf16") if i > 0 else ("f32",):
                xx = x.to(bf) if prec == "bf16" else x
                res[f"alexnet{i + 1} fwd {prec}"] = dck.direct_conv2d_blocked(
                    xx, conv.w, conv.b, spec.stride, spec.pads, "relu",
                    precision=prec, groups=spec.groups).float().cpu()
                res[f"alexnet{i + 1} wgrad {prec}"] = dck.direct_conv2d_wgrad(
                    xx, g, spec.hf, spec.wf, spec.stride, spec.pads, z,
                    "relu", True, precision=prec, groups=spec.groups)[0].cpu()
            hh = spec.ho
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", help="write this tree's outputs here")
    ap.add_argument("--compare", nargs=2, help="two saved files")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        diff = [k for k in a if k in b and not torch.equal(a[k], b[k])]
        print(f"[bits] {sum(k in b for k in a) - len(diff)} of {len(a)} "
              f"outputs bit for bit; differ: {diff}")
        return 1 if diff else 0
    if not torch.cuda.is_available():
        print("bits_ab: no CUDA device")
        return 1
    res = outputs(torch.device("cuda"))
    torch.save(res, args.save)
    print(f"[bits] {len(res)} outputs saved to {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
