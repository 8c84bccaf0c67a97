"""The deterministic, resumable token pipeline of the trainer."""
