"""Score table printing (reference eval.py:279-303), plain text."""


def _ansi(code):
    return lambda s: f"\033[{code}m{s}\033[0m"


color_progress = _ansi("1;36")
color_error = _ansi("1;31")
color_scores = _ansi("1;32")


def format_scores(all_metrics, method_names, dataset_names):
    """Lines of a table: one row per method, one column per (dataset,
    metric) headed ``DATASET (count) METRIC``, averages to 3 decimals."""
    table = [["Method"]]
    for method_name, method_metrics in zip(method_names, all_metrics):
        row = [method_name]
        for dataset_name, dataset_metrics in zip(dataset_names,
                                                 method_metrics):
            for metric in dataset_metrics.keys():
                if len(table) == 1:  # headers from the first method
                    table[0].append(f"{dataset_name} "
                                    f"({dataset_metrics.get_count(metric)})"
                                    f" {metric.upper()}")
                row.append(f"{dataset_metrics.get_average(metric):.3f}")
        table.append(row)
    widths = [max(len(r[i]) for r in table if i < len(r))
              for i in range(max(map(len, table)))]
    return ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in table]


def print_scores(all_metrics, method_names, dataset_names, config_name):
    print("")
    print(color_scores(f"Image Quality Scores (for {config_name} config)"))
    for line in format_scores(all_metrics, method_names, dataset_names):
        print(color_scores(line))
    print("")
