"""Request lifecycle: deadlines and cancellation budgets."""
