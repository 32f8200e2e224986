"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives.  NVIDIA's H100 data sheet, SXM
part, dense rates, at the full power limit of 700 W."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flop_per_s": 67e12},
}


def bound_s(device_name: str, n_bytes: float, n_flops: float):
    """The least time the card could take for ``n_bytes`` moved and
    ``n_flops`` float32 operations (outside the tensor cores), or None for
    a card without a row here."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    return max(n_bytes / peak["hbm_bytes_per_s"],
               n_flops / peak["fp32_flop_per_s"])
