"""Print the kbmod_tpu_torch version and environment info (kbmod-version).

    python -m kbmod_tpu_torch.cmdline.kbmod_version --full

``--full`` adds torch, numpy, the CUDA version torch was built with and
each CUDA device's name, where the JAX package's tool names jax's devices.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Display kbmod_tpu_torch version information.")
    parser.add_argument("--full", action="store_true", help="Include dependency/device info.")
    args = parser.parse_args(argv)

    import kbmod_tpu_torch

    print(f"kbmod_tpu_torch {kbmod_tpu_torch.__version__}")
    if args.full:
        import numpy
        import torch

        print(f"torch {torch.__version__}")
        print(f"numpy {numpy.__version__}")
        print(f"cuda {torch.version.cuda}")
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"devices: {count} CUDA")
        for i in range(count):
            print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")


if __name__ == "__main__":
    main()
