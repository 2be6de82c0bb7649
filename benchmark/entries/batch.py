"""A batch of pairs of one shape a request through
mgm_tpu_torch.stereo.compute_disparity_batch."""


def make(config, device):
    from mgm_tpu_torch import stereo
    from mgm_tpu_torch.config import MGMConfig

    cfg = MGMConfig(**config["settings"])
    outputs = tuple(config["outputs"])

    def serve(us, vs):
        out = stereo.compute_disparity_batch(us, vs, cfg, device=device,
                                             outputs=outputs)
        return out["disp"], out["cost"]
    return serve
