"""The FT core the serving path needs: replica map, coordinators and the
recovery planner (copies of their ``repro.core`` counterparts)."""
