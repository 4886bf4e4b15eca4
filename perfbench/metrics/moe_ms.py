"""``moe_ms``: forward and backward of one microbatch through the MoE
half (``models.layers.moe_apply_dropless``, its default route), bf16
activations over the first layer's f32 expert stacks and router,
gradients of the input and the weights; median of CUDA-event times."""
import torch


def read(run):
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg, t = run.mcfg, run.traffic
    if not cfg.moe.enabled:
        return None
    blk = M.layer_params(run.params["slots"][0], 0)
    w = {k: v.detach().requires_grad_(True) for k, v in blk["moe"].items()}
    shape = (t["rows"] // t["microbatches"], t["seq"], cfg.d_model)
    dt = run.pipe.dtype
    gen = run.generator(__name__)
    x = torch.randn(shape, generator=gen, device=run.device).to(dt).requires_grad_(True)
    gy = torch.randn(shape, generator=gen, device=run.device).to(dt)

    def call():
        y, _ = L.moe_apply_dropless(w, x, cfg)
        torch.autograd.grad(y, [x, *w.values()], gy)

    return run.cuda_ms(call)
