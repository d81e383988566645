"""The yardstick: peaks, analytic work, the reduction of a profiler trace,
and the comparison that decides ``correct``. Later changes to the program
do not edit it."""
