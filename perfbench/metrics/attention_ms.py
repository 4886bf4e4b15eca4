"""``attention_ms``: forward and backward of one microbatch through the
attention half (``models.layers.attention_apply`` with ``impl="auto"``,
as ``block_apply`` calls it under the stage kernel's route), bf16
activations over the first layer's f32 weights, gradients of the input
and the weights; median of CUDA-event times of repeated calls."""
import torch


def read(run):
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg, t = run.mcfg, run.traffic
    if cfg.num_attn_layers == 0:
        return None
    blk = M.layer_params(run.params["slots"][0], 0)
    w = {k: v.detach().requires_grad_(True) for k, v in blk["attn"].items()}
    shape = (t["rows"] // t["microbatches"], t["seq"], cfg.d_model)
    dt = run.pipe.dtype
    gen = run.generator(__name__)
    x = torch.randn(shape, generator=gen, device=run.device).to(dt).requires_grad_(True)
    gy = torch.randn(shape, generator=gen, device=run.device).to(dt)
    pos = torch.arange(t["seq"], device=run.device)

    def call():
        out, _ = L.attention_apply(w, x, cfg, positions=pos, impl="auto")
        torch.autograd.grad(out, [x, *w.values()], gy)

    return run.cuda_ms(call)
