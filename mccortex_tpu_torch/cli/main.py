"""mctx-torch: command dispatcher of the port (counterpart of
mccortex_tpu/cli/main.py).  `mctx-torch` or `python -m
mccortex_tpu_torch` with no arguments prints the command table."""

import sys


def _commands() -> dict:
    from . import commands, commands2, commands3, pipeline
    return {"build": (commands.cmd_build, "reads -> coloured .ctx graph"),
            "view": (commands.cmd_view, "print graph info / kmers"),
            "check": (commands.cmd_check, "validate graph file integrity"),
            "clean": (commands.cmd_clean,
                      "remove tips + low-coverage unitigs"),
            "unitigs": (commands.cmd_unitigs,
                        "dump unitigs as FASTA/GFA/DOT"),
            "inferedges": (commands.cmd_inferedges,
                           "infer population edges"),
            "contigs": (commands.cmd_contigs,
                        "assemble contigs from the graph (-p: with links)"),
            "thread": (commands.cmd_thread,
                       "thread reads through the graph -> .ctp links"),
            "pview": (commands.cmd_pview, "print a link file as text"),
            "subgraph": (commands2.cmd_subgraph,
                         "extract the neighbourhood of seed sequences"),
            "pjoin": (commands2.cmd_pjoin, "merge link files"),
            "join": (commands2.cmd_join, "merge graphs with colour offsets"),
            "dist": (commands2.cmd_dist,
                     "colour x colour shared-kmer matrix"),
            "sort": (commands2.cmd_sort, "sort a graph file's kmer records"),
            "index": (commands2.cmd_index,
                      "write a block index for a sorted graph"),
            "uniqkmers": (commands2.cmd_uniqkmers,
                          "emit unique kmers / flank seqs"),
            "rmsubstr": (commands2.cmd_rmsubstr,
                         "remove duplicate/substring seqs"),
            "reads": (commands2.cmd_reads,
                      "filter reads by graph membership"),
            "coverage": (commands2.cmd_coverage,
                         "per-kmer coverage of reads"),
            "correct": (commands3.cmd_correct,
                        "error-correct reads against the graph"),
            "links": (commands3.cmd_links, "clean / inspect link files"),
            "bubbles": (commands.cmd_bubbles,
                        "call bubbles between colours"),
            "popbubbles": (commands2.cmd_popbubbles,
                           "pop simple bubbles"),
            "breakpoints": (commands3.cmd_breakpoints,
                            "call breakpoints vs reference"),
            "calls2vcf": (commands3.cmd_calls2vcf,
                          "decompose calls into VCF"),
            "vcfcov": (commands3.cmd_vcfcov,
                       "annotate VCF with kmer coverage"),
            "vcfgeno": (commands3.cmd_vcfgeno,
                        "genotype VCF from kmer coverage"),
            "pipeline": (pipeline.cmd_pipeline,
                         "run the full multi-sample workflow"),
            "server": (commands2.cmd_server,
                       "interactive kmer query server"),
            "exp_abc": (commands2.cmd_exp_abc,
                        "traversal consistency experiment (hidden)"),
            "hashtest": (commands3.cmd_hashtest,
                         "kmer store micro-benchmark")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    commands = _commands()
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: mctx-torch <command> [args]\n\ncommands:")
        for name, (_, summary) in sorted(commands.items()):
            print(f"  {name:12s} {summary}")
        return 0
    cmd = argv[0]
    if cmd not in commands:
        print(f"mctx-torch: unknown command '{cmd}'", file=sys.stderr)
        return 1
    try:
        return commands[cmd][0](argv[1:]) or 0
    except (ValueError, OSError) as e:
        print(f"mctx-torch {cmd}: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
