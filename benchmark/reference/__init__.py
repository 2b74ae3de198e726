"""The benchmark's plain references: the count in plain torch, the
catalog in a frozen copy of the host engine (numpy)."""
