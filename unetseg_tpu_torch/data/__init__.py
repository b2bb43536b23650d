"""Data: CTC file layout and the in-memory dataset."""
