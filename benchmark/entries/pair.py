"""One pair a request through mgm_tpu_torch.stereo.compute_disparity."""


def make(config, device):
    from mgm_tpu_torch import stereo
    from mgm_tpu_torch.config import MGMConfig

    cfg = MGMConfig(**config["settings"])
    outputs = tuple(config["outputs"])

    def serve(us, vs):
        out = stereo.compute_disparity(us[0], vs[0], cfg, device=device,
                                       outputs=outputs)
        return out["disp"][None], out["cost"][None]
    return serve
