"""``python -m repro_torch.pool`` — elastic task-pool demo CLI."""
from repro_torch.pool.demo import main

if __name__ == "__main__":
    raise SystemExit(main())
