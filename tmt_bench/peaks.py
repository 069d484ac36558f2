"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheets, dense rates,
at the full power limit (700 W for the SXM part)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12},
    "NVIDIA H100 PCIe": {"hbm_bytes_per_s": 2.0e12, "bf16_flops_per_s": 756e12},
}


def peak(kind: str, what: str):
    """The card's peak ``what``, or None for a card not in the table."""
    return PEAKS.get(kind, {}).get(what)
