"""RL fine-tuning (the fine-tune job)."""
