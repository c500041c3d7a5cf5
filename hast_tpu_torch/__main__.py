"""`python -m hast_tpu_torch` == `python -m hast_tpu_torch.cli`."""

from hast_tpu_torch.cli import main

if __name__ == "__main__":
    main()
