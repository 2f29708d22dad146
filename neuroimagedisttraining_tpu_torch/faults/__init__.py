"""Seeded client-activity schedules."""
