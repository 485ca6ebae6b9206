"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives.  NVIDIA's data sheet for the H100
SXM part, dense rates, at its full 700 W power limit; a card set below that
limit runs slower under load, so each traced run prints the card's limit
beside these numbers."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops_per_s": 67e12,      # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
        "power_w": 700.0,
    },
}
