"""Distribution (torch port): the int8 gradient codec."""
