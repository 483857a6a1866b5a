"""What a call of each timed entry covers, counted from the data and the
call: `values(dataset, kwargs)` and `work_of(dataset, kwargs)`."""
