"""The FT core: replica map, coordinators, the recovery planner and the
checkpoint-interval policy (copies of their ``repro.core`` counterparts)."""
