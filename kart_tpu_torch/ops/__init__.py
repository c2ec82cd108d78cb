"""Device operations: FM-index seeding and Needleman-Wunsch planes."""
