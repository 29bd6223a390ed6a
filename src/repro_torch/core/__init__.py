"""OnPair16 training, the frozen dictionary layouts and the codec API."""
