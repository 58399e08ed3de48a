"""The selections, judged by what they say: every SNP a call selects is
one of the QTL the cohort planted, and every call makes all ``maxit``
selections (every planted effect explains at least ``min(qtl_shares)`` of
its trait's variance, far above what extBIC asks at these sizes)."""


class Check:
    def __init__(self, run):
        self.run = run
        self.planted = {int(q) for q in run.cohort.qtl}
        self.not_planted = 0
        self.short = 0

    def targets(self):
        return {}

    def listen(self, name, args, out):
        pass

    def observe(self, call, traits, results):
        if results is None:
            return
        for res in results:
            self.not_planted += sum(int(j) not in self.planted
                                    for j in res.indices)
            self.short += len(res.indices) < self.run.cell.maxit

    def judge(self):
        return {"not_planted": self.not_planted, "short_calls": self.short}

    def control(self):
        return {"not_planted": 0, "short_calls": 0}
