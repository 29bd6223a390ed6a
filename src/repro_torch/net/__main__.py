"""``python -m repro_torch.net <shard-dir>`` — run one shard server process."""

from repro_torch.net.shard_server import main

if __name__ == "__main__":
    main()
