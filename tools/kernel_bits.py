"""Checksums of the outputs of the port's kernels that a kernel redesign
leaves alone, on seeded inputs at the main paths' shapes, on one NVIDIA
GPU: K3 forward and backward (``fused_mlp``, ``fused_mlp_bwd``: dx alone
and with the weight gradients) at cropnerf-mxu's heads, at a 3-layer
256-wide net no preset builds (-huge's colour head with a second hidden
layer, on the stream route ``csrc/fused_mlp_stream.cu``; its lines differ
between trees that send it to other kernels), and at the
128- and 256-wide heads of cropnerf-mxu-big and -huge; K4
forward (``hash_encode_fwd``); K5 forward (``fused_pe_mlp`` without a
graph) and backward (``fused_pe_mlp_bwd``: dx and every weight gradient)
at cropnerf-mxu's proposal nets, and K5 at cropnerf-mxu-q's 128-wide nets
(the forward, and the backward where the tree has a kernel for them:
their route, and so their bits, differ between trees that send them to
other kernels); last K1 and K2 forward and backward (``fused_pe_nerf``,
``fused_pe_density``; K2's dx alone) at cropnerf-mxu's rows and K6
(``render_weights_cuda``); then K5 on the stream route at [prop256]'s
nets (3 layers 256 wide, F = 5 and 6: forward, and the backward with dx
and dW); last K3's stream route at -huge's 256-wide semantic head and at
[w512]'s 512-wide one, K5's at [w512]'s nets (3 x 512), and K1 and K2 at
[w512]'s field (trunk and semantic head 512 wide: K1 forward and
backward, K2 forward, its dx alone and its backward with dW), and the
same at [w1024]'s (a 1024-wide trunk, 64-wide heads), where the tree
takes them ("no kernel" otherwise).  Run it on two trees in one call
on the same card; equal lines mean equal bits:

    python3 tools/kernel_bits.py [--port-root DIR]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port-root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    sys.path.insert(0, str(args.port_root.resolve()))
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.proposal import proposal_init
    from cropnerf_tpu_torch.ops import hashgrid as hg
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as kmlp
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kfield
    from cropnerf_tpu_torch.ops.cuda import hash_encode as kh
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    with torch.no_grad():
        # K3: the vanilla field's heads at an export chunk and a BayesRays
        # batch (the 3-layer 256-wide net comes last, so that the draws
        # before it are those of earlier versions of this script)
        def k3(name, dims):
            wbs = []
            for a, b in zip(dims[:-1], dims[1:]):
                wbs += [torch.randn((a, b), generator=g, device=dev) / a ** 0.5,
                        torch.randn((1, b), generator=g, device=dev) * 0.05]
            x = torch.randn((65_536, dims[0]), generator=g, device=dev)
            out[f"fused_mlp {name}"] = digest([kmlp.fused_mlp(x, wbs)])
            x = torch.randn((196_605, dims[0]), generator=g, device=dev)
            cot = torch.randn((196_605, dims[-1]), generator=g, device=dev)
            for need_dw in (False, True):
                dx, dw = kmlp.fused_mlp_bwd(x, wbs, cot, True, need_dw)
                out[f"fused_mlp_bwd {name} dW={need_dw}"] = digest(
                    [dx] + (dw or []))

        k3("semantic head", (15, 64, 1))
        k3("colour head", (74, 64, 3))
        # K4: a cropnerf step's three encodes
        m = PRESETS["cropnerf"].model
        for name, n, gc in (("field", 196_608, m.field.grid),
                            ("proposal 0", 1_048_576, m.proposal_fields[0].grid),
                            ("proposal 1", 393_216, m.proposal_fields[1].grid)):
            res = hg.level_resolutions(gc.num_levels, gc.min_res, gc.max_res)
            t = 2 ** gc.log2_hashmap_size
            table = torch.rand((sum(hg.level_row_counts(res, t)), 2),
                               generator=g, device=dev) * 2 - 1
            pos = torch.rand((n, 3), generator=g, device=dev)
            table2d, offsets, dense, _ = hg._table_layout(table, res, "auto", t)
            out[f"hash_encode {name}"] = digest([kh.hash_encode_fwd(
                table2d, pos, tuple(res), tuple(offsets), tuple(dense), t)])
        # K5: the fused proposal nets of cropnerf-mxu, the forward (no graph)
        # and the backward with dx and dW; then -q's 128-wide nets' forward
        # (their backward last, for the same draws as before)
        q_nets = []
        for preset in ("cropnerf-mxu", "cropnerf-mxu-q"):
            mx = PRESETS[preset].model
            for i, (p, smp) in enumerate(zip(mx.proposal_fields,
                                             mx.num_proposal_samples_per_ray)):
                prop = proposal_init(p, torch.Generator().manual_seed(i), dev)
                wbs = [t.detach() for w, b in zip(prop.mlp.w, prop.mlp.b)
                       for t in (w, b.reshape(1, -1))]
                x = torch.rand((4096 * smp, 3), generator=g, device=dev) * 2 - 1
                tag = "" if preset == "cropnerf-mxu" else " 128 wide"
                out[f"fused_pe_mlp{tag} net {i}"] = digest(
                    [kfield.fused_pe_mlp(x, wbs, p.pe_freqs)])
                if tag:
                    q_nets.append((i, x, wbs, p.pe_freqs))
                if preset == "cropnerf-mxu":
                    cot = torch.randn((4096 * smp, 1), generator=g, device=dev)
                    dx, dw = kfield.fused_pe_mlp_bwd(x, wbs, p.pe_freqs, cot)
                    out[f"fused_pe_mlp_bwd net {i}"] = digest([dx] + dw)
        k3("3-layer 256-wide net", (89, 256, 256, 3))
        for i, x, wbs, F in q_nets:
            cot = torch.randn((x.shape[0], 1), generator=g, device=dev)
            try:
                dx, dw = kfield.fused_pe_mlp_bwd(x, wbs, F, cot)
            except ValueError:
                out[f"fused_pe_mlp_bwd 128 wide net {i}"] = "no kernel"
            else:
                out[f"fused_pe_mlp_bwd 128 wide net {i}"] = digest([dx] + dw)
        k3("-big semantic head", (30, 128, 128, 1))
        k3("-big colour head", (185, 128, 3))
        k3("-huge colour head", (89, 256, 3))
        # K1 and K2 (the PE field, forward and backward) at a cropnerf-mxu
        # training step's and BayesRays batch's rows, K6 at a training
        # step's compositing shape (last, for the same draws as before)
        from cropnerf_tpu_torch.models.model import model_init
        from cropnerf_tpu_torch.models.vanilla import (POS_FREQS,
                                                       fused_field_weights)
        from cropnerf_tpu_torch.ops.cuda.transmittance import (
            render_weights_cuda)
        mx = PRESETS["cropnerf-mxu"].model
        params = model_init(mx, 8, torch.Generator().manual_seed(0), dev)
        base, top, color, sem = (
            [w.detach() for w in ws]
            for ws in fused_field_weights(params.field, mx.field))
        n = 4096 * mx.num_nerf_samples_per_ray
        x = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        ex = torch.randn((n, color[1].shape[0]), generator=g, device=dev)
        outs = kfield.fused_pe_nerf(x, ex, base, top, color, sem, POS_FREQS)
        out["fused_pe_nerf"] = digest(outs)
        cots = [torch.randn(o.shape, generator=g, device=dev) for o in outs]
        grads = kfield.fused_pe_nerf_bwd(x, ex, base, top, color, sem,
                                         POS_FREQS, *cots)
        out["fused_pe_nerf_bwd"] = digest(
            list(grads[:2]) + [t for grp in grads[2:] for t in grp])
        t = kfield.fused_pe_density(x, base, top, POS_FREQS)
        out["fused_pe_density"] = digest([t])
        dx, _, _ = kfield.fused_pe_density_bwd(
            x, base, top, POS_FREQS, torch.randn(t.shape, generator=g,
                                                 device=dev), True, False)
        out["fused_pe_density_bwd dx"] = digest([dx])
        density = torch.rand((4096, 256), generator=g, device=dev) * 4
        deltas = torch.rand((4096, 256), generator=g, device=dev) * 0.02
        out["render_weights_cuda"] = digest([render_weights_cuda(density,
                                                                 deltas)])
        # K5's stream route at [prop256]'s nets (last, for the same draws
        # as before)
        for i, (F, smp) in enumerate(((5, 256), (6, 96))):
            din = 3 * (1 + 2 * F)
            wbs = []
            for a, b in zip((din, 256, 256), (256, 256, 1)):
                wbs += [torch.randn((a, b), generator=g, device=dev) / a ** 0.5,
                        torch.randn((1, b), generator=g, device=dev) * 0.05]
            x = torch.rand((4096 * smp, 3), generator=g, device=dev) * 2 - 1
            cot = torch.randn((4096 * smp, 1), generator=g, device=dev)
            out[f"fused_pe_mlp 256 wide net {i}"] = digest(
                [kfield.fused_pe_mlp(x, wbs, F)])
            dx, dw = kfield.fused_pe_mlp_bwd(x, wbs, F, cot)
            out[f"fused_pe_mlp_bwd 256 wide net {i}"] = digest([dx] + dw)
        # the stream route's heads (K3) and [w512]'s nets (K5), then K1 and
        # K2 at [w512]'s field (last, for the same draws as before)
        def no_kernel(name, fn):
            try:
                fn()
            except ValueError:
                out[name] = "no kernel"

        no_kernel("fused_mlp -huge semantic head 256 wide",
                  lambda: k3("-huge semantic head 256 wide", (30, 256, 256, 1)))
        no_kernel("fused_mlp [w512] semantic head",
                  lambda: k3("[w512] semantic head", (15, 512, 1)))
        for i, (F, smp) in enumerate(((5, 256), (6, 96))):
            din = 3 * (1 + 2 * F)
            wbs = []
            for a, b in zip((din, 512, 512), (512, 512, 1)):
                wbs += [torch.randn((a, b), generator=g, device=dev) / a ** 0.5,
                        torch.randn((1, b), generator=g, device=dev) * 0.05]
            x = torch.rand((4096 * smp, 3), generator=g, device=dev) * 2 - 1
            cot = torch.randn((4096 * smp, 1), generator=g, device=dev)

            def k5(i=i, x=x, wbs=wbs, F=F, cot=cot):
                out[f"fused_pe_mlp 512 wide net {i}"] = digest(
                    [kfield.fused_pe_mlp(x, wbs, F)])
                dx, dw = kfield.fused_pe_mlp_bwd(x, wbs, F, cot)
                out[f"fused_pe_mlp_bwd 512 wide net {i}"] = digest([dx] + dw)

            no_kernel(f"fused_pe_mlp 512 wide net {i}", k5)
        import dataclasses
        mw = dataclasses.replace(mx, field=dataclasses.replace(
            mx.field, hidden_dim=512, hidden_dim_semantics=512))
        params = model_init(mw, 8, torch.Generator().manual_seed(0), dev)
        base, top, color, sem = (
            [w.detach() for w in ws]
            for ws in fused_field_weights(params.field, mw.field))
        n = 4096 * mw.num_nerf_samples_per_ray
        x = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        ex = torch.randn((n, color[1].shape[0]), generator=g, device=dev)

        def k1_k2():
            outs = kfield.fused_pe_nerf(x, ex, base, top, color, sem, POS_FREQS)
            out["fused_pe_nerf 512 wide"] = digest(outs)
            cots = [torch.randn(o.shape, generator=g, device=dev)
                    for o in outs]
            grads = kfield.fused_pe_nerf_bwd(x, ex, base, top, color, sem,
                                             POS_FREQS, *cots)
            out["fused_pe_nerf_bwd 512 wide"] = digest(
                list(grads[:2]) + [t for grp in grads[2:] for t in grp])
            t = kfield.fused_pe_density(x, base, top, POS_FREQS)
            out["fused_pe_density 512 wide"] = digest([t])
            cot = torch.randn(t.shape, generator=g, device=dev)
            dx, _, _ = kfield.fused_pe_density_bwd(x, base, top, POS_FREQS,
                                                   cot, True, False)
            out["fused_pe_density_bwd dx 512 wide"] = digest([dx])
            dx, db_, dt_ = kfield.fused_pe_density_bwd(x, base, top,
                                                       POS_FREQS, cot)
            out["fused_pe_density_bwd 512 wide"] = digest([dx, *db_, *dt_])

        no_kernel("fused_pe_nerf 512 wide", k1_k2)
        # K1 and K2 at [w1024]'s field (last, for the same draws as before)
        mw = dataclasses.replace(mx, field=dataclasses.replace(
            mx.field, hidden_dim=1024))
        params = model_init(mw, 8, torch.Generator().manual_seed(0), dev)
        base, top, color, sem = (
            [w.detach() for w in ws]
            for ws in fused_field_weights(params.field, mw.field))
        x = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        ex = torch.randn((n, color[1].shape[0]), generator=g, device=dev)

        def k1_k2_1024():
            outs = kfield.fused_pe_nerf(x, ex, base, top, color, sem, POS_FREQS)
            out["fused_pe_nerf 1024 wide"] = digest(outs)
            cots = [torch.randn(o.shape, generator=g, device=dev)
                    for o in outs]
            grads = kfield.fused_pe_nerf_bwd(x, ex, base, top, color, sem,
                                             POS_FREQS, *cots)
            out["fused_pe_nerf_bwd 1024 wide"] = digest(
                list(grads[:2]) + [t for grp in grads[2:] for t in grp])
            t = kfield.fused_pe_density(x, base, top, POS_FREQS)
            out["fused_pe_density 1024 wide"] = digest([t])
            cot = torch.randn(t.shape, generator=g, device=dev)
            dx, _, _ = kfield.fused_pe_density_bwd(x, base, top, POS_FREQS,
                                                   cot, True, False)
            out["fused_pe_density_bwd dx 1024 wide"] = digest([dx])
            dx, db_, dt_ = kfield.fused_pe_density_bwd(x, base, top,
                                                       POS_FREQS, cot)
            out["fused_pe_density_bwd 1024 wide"] = digest([dx, *db_, *dt_])

        no_kernel("fused_pe_nerf 1024 wide", k1_k2_1024)
    print(json.dumps({"port_root": str(args.port_root),
                      "card": torch.cuda.get_device_name(0), "sha256": out}),
          flush=True)


if __name__ == "__main__":
    main()
